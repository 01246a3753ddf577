"""Pullback-metric SVD: top-k singular triplets of a network Jacobian.

Counterpart of diffusion_pullback_tpu/geometry/pullback.py. Each iteration
of the subspace power iteration is

    u_i = vmap(jvp)(v_i)          # r tangent passes, batched over probes
    ṽ_i = vmap(vjp_fn)(u_i)       # r cotangent passes through ONE vjp
    s, v ← short-fat SVD of ṽ     # QR of ṽᵀ, then the SVD of the r×r R
    v    ← sign-aligned to the previous iterate

torch has no `linear_transpose`, so the cotangent half always takes the
shape of the JAX package's ``fn_vjp`` branch: one `torch.func.vjp` of the
map (of ``fn_vjp`` when given), whose function is vmapped over the probes.
The tangent half runs `torch.func.jvp` per pass, which evaluates the
primal again each time (`linearize`, which traces the kernels through
their custom ops, would run it once; ROADMAP item 10). ``batched_local_pullback`` runs B independent
pullbacks of a per-sample map as one, the probes of every sample sharing
each pass.

The phases are spans (utils/profiling.py), recorded under a profiler:
``vjp_primal`` (the cotangent half's one vjp), ``probes`` (the probes'
QR and their copy to the device), per iteration ``tangent``,
``cotangent``, ``svd`` (with the sign alignment) and ``delta_wait`` (the
host waiting for δ), each with field ``it``, then ``final_tangent``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.func import jvp, vjp, vmap

from ..utils.profiling import span


class PullbackResult(NamedTuple):
    """Top-k singular triplets of J = ∂f/∂x at the evaluation point: ``u``
    (dim_h, k) with column norms ≈ σ_k, ``s`` (k,) ≈ σ_k, ``vT`` (k, dim_x)
    with unit rows — the JAX package's field set."""

    u: torch.Tensor
    s: torch.Tensor
    vT: torch.Tensor
    iterations: int
    final_delta: float


def _orthonormal_probes(generator: torch.Generator, dim: int, rank: int
                        ) -> torch.Tensor:
    """(rank, dim) matrix with orthonormal rows (QR of a Gaussian block)."""
    g = torch.randn(dim, rank, generator=generator, dtype=torch.float32)
    q, _ = torch.linalg.qr(g)
    return q.T


def _short_fat_svd(m: torch.Tensor, eps: float = 1e-12, method: str = "qr"):
    """SVD of a short-fat (…, r, d) matrix without a d-sized SVD. Returns
    (s descending, vT with unit rows); leading axes are a batch.

      'qr'   (default): the tall QR of mᵀ, then the SVD of the r×r R
             factor; conditioning ∝ σ, accurate down the spectrum's tail.
      'gram': eigh of m mᵀ; one matmul cheaper, conditioning ∝ σ², so
             directions with σ_k/σ_1 ≲ √eps_f32 are lost.
    """
    if method == "gram":
        w, q = torch.linalg.eigh(m @ m.mT)   # ascending, as jnp.linalg.eigh
        w, q = w.flip(-1), q.flip(-1)
        s = torch.sqrt(torch.clamp(w, min=0.0))
        vT = (q.mT @ m) / torch.clamp(s, min=eps)[..., None]
        # a numerically rank-deficient Gram (σ_k/σ_1 ≲ eps_f32^(1/4)) blows
        # rows up at the eps division and the iteration diverges to NaN:
        # re-unitise, so it merely loses accuracy
        return s, vT / torch.clamp(torch.linalg.norm(vT, dim=-1, keepdim=True), min=eps)
    if method == "qr":
        qtall, rfac = torch.linalg.qr(m.mT)     # mᵀ = Q (d×r) · R (r×r)
        _, s, wT = torch.linalg.svd(rfac.mT)    # m = Rᵀ Qᵀ = U S (Wᵀ Qᵀ)
        return s, wT @ qtall.mT
    raise ValueError(f"unknown svd method: {method!r}")


def _batched(fn: Callable, chunk_size: Optional[int], rank: int, axis: int = 0):
    """vmap ``fn`` over the probe axis ``axis``; with ``chunk_size`` a loop
    of vmaps over chunks of that many probes, to bound peak memory."""
    f = vmap(fn, in_dims=axis, out_dims=axis)
    if chunk_size is None or chunk_size >= rank:
        return f
    if rank % chunk_size != 0:
        raise ValueError(f"pca_rank {rank} must be divisible by chunk_size {chunk_size}")
    return lambda batch: torch.cat([f(c) for c in batch.split(chunk_size, dim=axis)],
                                   dim=axis)


def _cotangent_pass(fn: Callable, x: torch.Tensor, remat: bool, out_shape):
    """u ↦ Jᵀu of ``fn`` at ``x`` (reshaped to ``out_shape``), to be vmapped
    over the probes. By default one vjp of ``fn`` at ``x`` serves every
    pass, holding its activations for the whole iteration; with ``remat``
    each call takes its own vjp (the forward again), so they live only
    during that pass."""
    def pull(h, vjp_fn, u):
        return vjp_fn(u.reshape(h.shape).to(h.dtype))[0].reshape(out_shape)

    if remat:
        return lambda u: pull(*vjp(fn, x), u)
    with span("vjp_primal"):
        h, vjp_fn = vjp(fn, x)
    return lambda u: pull(h, vjp_fn, u)


def _power_iteration(fwd, bwd, v, min_iter, max_iter, atol, svd_method,
                     probe_group=None) -> PullbackResult:
    """The subspace power iteration from the probes ``v`` (…, r, dim_x),
    any leading axes a batch sharing the iteration count and δ (the max
    over it). With ``probe_group`` each rank of the group runs the tangent
    and cotangent passes of its r/n rows of the iterate, the rows are
    gathered for the short-fat SVD, and the SVD's result is the group's
    first rank's on every rank, so every rank computes the same δ and
    leaves the loop at the same iteration (a rank that left alone would
    hang the others' gather)."""
    if probe_group is None:
        rows = gather = agree = lambda a: a
    else:
        from ..parallel.collectives import from_first, gather_rows

        n, me = dist.get_world_size(probe_group), dist.get_rank(probe_group)
        rows = lambda a: a[me * (a.shape[0] // n):(me + 1) * (a.shape[0] // n)]
        gather = lambda a: gather_rows(a, probe_group)
        agree = lambda a: from_first(a, probe_group)
    s = torch.zeros(v.shape[:-1], device=v.device)
    delta, it = math.inf, 0
    while it < max_iter and (it <= min_iter + 1 or delta > atol):
        with span("tangent", it=it):
            u = fwd(rows(v))
        with span("cotangent", it=it):
            c = bwd(u)
            # free each block once used, as one nested call would: the
            # (r, dim_h) tangents before the gather, the cotangent before
            # the SVD, so that only its f32 copy reaches the SVD
            del u
            m = gather(c).float()
            del c
        with span("svd", it=it):
            s, v_new = _short_fat_svd(m, method=svd_method)
            del m
            # sign-align rows to the previous iterate: no ± flapping in the
            # convergence test or the result
            signs = torch.sign((v_new * v).sum(dim=-1))
            signs = torch.where(signs == 0, torch.ones_like(signs), signs)
            v_new, s = agree(v_new * signs[..., None]), agree(s)
        with span("delta_wait", it=it):
            delta = (v_new - v).abs().max().item()
        v, it = v_new, it + 1

    # final tangent pass so u belongs to the converged v
    with span("final_tangent"):
        u = gather(fwd(rows(v)))
    return PullbackResult(u=u.mT, s=torch.sqrt(s), vT=v, iterations=it,
                          final_delta=delta)


def local_pullback(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    pca_rank: int = 50,
    min_iter: int = 10,
    max_iter: int = 50,
    atol: float = 1e-3,
    v_init: Optional[torch.Tensor] = None,
    fn_vjp: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    chunk_size: Optional[int] = None,
    remat: bool = False,
    svd_method: str = "qr",
    probe_group=None,
) -> PullbackResult:
    """Top-``pca_rank`` singular triplets of ∂fn/∂x at ``x``.

    ``fn`` maps one sample (with its leading batch axis, usually 1) to a
    feature tensor; torch.func must be able to jvp, vjp and vmap it. The
    earliest converged exit comes after min_iter + 2 iterations (the
    reference's 0-based ``i > min_iter`` break), else at ``max_iter``.
    ``v_init`` (pca_rank, dim_x) replaces the seeded orthonormal probes,
    so a test can hand both packages the same start.

    ``fn_vjp``: a second implementation of the same map for the cotangent
    half, as in the JAX package, for an ``fn`` whose kernels have only a
    forward-mode rule (attn_impl 'flash_jvp'): the tangent passes run
    ``fn``, the vjp runs ``fn_vjp`` ('flash').

    ``remat``: each cotangent pass runs its own vjp, so the map's saved
    activations live only during that pass, not across the iteration (the
    tangent passes hold none); the numbers do not change. ``svd_method``:
    'qr' or 'gram' (``_short_fat_svd``).

    ``probe_group`` (a torch.distributed process group, the mesh's 'probe'
    axis; where JAX takes ``probe_sharding``): each of its n ranks runs the
    tangent and cotangent passes of r/n probes, and the (r, dim_x) iterate
    is gathered for the SVD (``_power_iteration``). The probes are drawn
    whole on every rank from ``generator``, so the basis does not depend on
    n. ``u`` and ``vT`` come back whole on every rank. Mutually exclusive
    with ``chunk_size``; ``pca_rank`` must divide by n.
    """
    if probe_group is not None:
        if chunk_size is not None:
            raise ValueError("probe_group and chunk_size are mutually exclusive")
        n = dist.get_world_size(probe_group)
        if pca_rank % n:
            raise ValueError(f"pca_rank {pca_rank} not divisible by the probe "
                             f"group's {n} ranks")
    x = x.to(torch.float32)
    dim_x = math.prod(x.shape)
    fwd = _batched(lambda vi: jvp(fn, (x,), (vi.reshape(x.shape),))[1].reshape(-1),
                   chunk_size, pca_rank)
    bwd = _batched(_cotangent_pass(fn if fn_vjp is None else fn_vjp, x, remat, (-1,)),
                   chunk_size, pca_rank)

    if v_init is not None:
        if tuple(v_init.shape) != (pca_rank, dim_x):
            raise ValueError(
                f"v_init shape {tuple(v_init.shape)} != ({pca_rank}, {dim_x})")
        v = torch.as_tensor(v_init, dtype=torch.float32).to(x.device)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with span("probes"):
            v = _orthonormal_probes(generator, dim_x, pca_rank).to(x.device)
    return _power_iteration(fwd, bwd, v, min_iter, max_iter, atol, svd_method,
                            probe_group)


def batched_local_pullback(
    fn: Callable[[torch.Tensor], torch.Tensor],
    xs: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    pca_rank: int = 50,
    min_iter: int = 10,
    max_iter: int = 50,
    atol: float = 1e-3,
    chunk_size: Optional[int] = None,
    remat: bool = False,
    svd_method: str = "qr",
    fn_vjp: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    v_init: Optional[torch.Tensor] = None,
) -> PullbackResult:
    """B independent pullbacks in one: ``fn`` maps a (B, …) batch to
    (B, …) and must be per-sample independent (sample b's output depends
    only on sample b's input), so the Jacobian is block-diagonal and probe
    i of every sample shares one tangent pass at batch B.

    The iterates are (B, r, dim), the probe axis vmapped at axis 1;
    ``chunk_size``, ``remat``, ``svd_method`` and ``fn_vjp`` as in
    ``local_pullback``, the cotangent half one vjp of the batch map. The
    result has a leading B axis: u (B, dim_h, r), s (B, r), vT (B, r,
    dim_x); ``iterations`` and ``final_delta`` are shared (δ the max over
    the batch), so with atol > 0 the loop runs until every sample has
    converged. ``v_init`` (B, r, dim_x) replaces the default, one
    orthonormal block per sample drawn in turn from ``generator``."""
    xs = xs.to(torch.float32)
    batch, dim_x = xs.shape[0], math.prod(xs.shape[1:])
    fwd = _batched(
        lambda vi: jvp(fn, (xs,), (vi.reshape(xs.shape),))[1].reshape(batch, -1),
        chunk_size, pca_rank, axis=1)
    bwd = _batched(_cotangent_pass(fn if fn_vjp is None else fn_vjp, xs, remat,
                                   (batch, -1)), chunk_size, pca_rank, axis=1)

    if v_init is not None:
        if tuple(v_init.shape) != (batch, pca_rank, dim_x):
            raise ValueError(f"v_init shape {tuple(v_init.shape)} != "
                             f"({batch}, {pca_rank}, {dim_x})")
        v = torch.as_tensor(v_init, dtype=torch.float32).to(xs.device)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with span("probes"):
            v = torch.stack([_orthonormal_probes(generator, dim_x, pca_rank)
                             for _ in range(batch)]).to(xs.device)
    return _power_iteration(fwd, bwd, v, min_iter, max_iter, atol, svd_method)


def local_encoder_pullback(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                           sample: torch.Tensor, generator=None, **kwargs
                           ) -> PullbackResult:
    """Pullback of the U-Net encoder x_t → h: ``encode_fn`` is closed over
    the weights, timestep, condition and tap."""
    return local_pullback(encode_fn, sample, generator, **kwargs)


def local_decoder_pullback(decode_fn: Callable[[torch.Tensor], torch.Tensor],
                           h: torch.Tensor, generator=None, **kwargs
                           ) -> PullbackResult:
    """Pullback of the decoder h → ε (or of the Tweedie x̂₀ when
    ``decode_fn`` wraps it)."""
    return local_pullback(decode_fn, h, generator, **kwargs)


def pullback_covector(fn: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """v = Jᵀu for one covector u of fn(x) (any shape with its number of
    elements): one VJP of ⟨u, f(x)⟩. v has x's shape and dtype."""
    h, vjp_fn = vjp(fn, x)
    (v,) = vjp_fn(u.reshape(h.shape).to(h.dtype))
    return v
