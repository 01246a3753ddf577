"""The output check: a unit's basis as the program wrote it against the
plain reference's, recomputed from the same inputs (weights, z_t, t,
conditioning, probe seed), and the numbers compared:

    sigma       max_k |σ_k − σ_k,ref| / σ_k,ref over the r singular values
    v_subspace  mean sin² of the principal angles between the rows of vT
                and of vT_ref (1 − ‖Q_v Q_v,refᵀ‖²_F / r)
    u_subspace  the same for the column spaces of u and u_ref

The reference runs in float32 (TF32 off), or, as the control, in the
format below the configuration's (arith.LOWER)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.arith import arith, no_tf32
from ..reference.pullback import power_iteration, probes
from ..reference.unet import layout, mid_tap_map
from . import system, weights


def _subspace_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Mean sin² of the principal angles between the column spaces of a
    and b (dim, r)."""
    qa = np.linalg.qr(a.astype(np.float64))[0]
    qb = np.linalg.qr(b.astype(np.float64))[0]
    return float(1.0 - np.linalg.norm(qa.T @ qb) ** 2 / a.shape[1])


def basis_numbers(got, ref) -> dict:
    (u, s, vT), (ur, sr, vTr) = got, ref
    return {
        "sigma": float(np.max(np.abs(s - sr) / sr)),
        "v_subspace": _subspace_gap(vT.T, vTr.T),
        "u_subspace": _subspace_gap(u, ur),
    }


def reference_basis(cfg: dict, traffic: dict, seed: int, unit: int, device,
                    arithmetic: str = "float32"):
    """(u, s, vT) of unit ``unit`` of run ``seed`` by the plain reference:
    the U-Net's weights drawn again from the seed in the served dtype and
    widened to float32, ``arithmetic`` 'float32', 'bfloat16' or 'fp8'."""
    no_tf32()
    u = cfg["unet"]
    P = {n: t.float() for n, t in weights.draw(
        layout(u), seed, system.STREAM_UNET, device,
        getattr(torch, cfg["unet_dtype"])).items()}
    ctx = system.draw_context(cfg, seed, device)
    z = system.draw_latent(cfg, seed, unit, device)
    t = system.unit_t(traffic, seed, unit)
    f = mid_tap_map(P, u, arith(arithmetic), torch.tensor(t, device=device), ctx)
    v = probes(system.unit_seed(seed, unit), z.numel(), traffic["pca_rank"]).to(device)
    res = power_iteration(f, z, v, traffic["pullback_min_iter"],
                          traffic["pullback_max_iter"], traffic["pullback_atol"],
                          chunk=traffic["probe_chunk"])
    uu, s, vT, _ = res
    return uu.cpu().numpy(), s.cpu().numpy(), vT.cpu().numpy()


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number finite and at most
    its limit; a number without a limit fails."""
    rows = [(k, v, limits.get(k, {}).get("limit")) for k, v in numbers.items()]
    ok = all(lim is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
