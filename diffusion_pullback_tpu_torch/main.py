"""Command-line entry point of the port: the SD 2.1-base subset of the JAX
package's main.py (build_sd and the edit dispatch), with the same flag names.

    python -m diffusion_pullback_tpu_torch.main --note smoke \\
        --run_edit_local_encoder_pullback_zt True

Runs on CUDA unless ``--device cpu`` is given. With no checkpoint in the
repository, the models take seeded random weights (--seed), as the JAX CLI
does without --checkpoint_path.
"""

from __future__ import annotations

import argparse
import os
import sys

DATASET = "noise"  # the one dataset of this path: seeded noise images


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diffusion_pullback_tpu_torch.main")
    p.add_argument("--note", type=str, required=True)
    p.add_argument("--sample_idx", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="",
                   help="'' = cuda (raises without a card); 'cpu' to force")
    p.add_argument("--dtype", type=str, default="", choices=["", "fp32", "bf16"],
                   help="U-Net compute/weight dtype; '' = bf16 on cuda, fp32 "
                        "on cpu (the VAE and text tower stay fp32)")
    p.add_argument("--result_folder", type=str, default="./runs/")
    p.add_argument("--for_prompt", type=str, default="")
    p.add_argument("--inv_prompt", type=str, default="")
    p.add_argument("--neg_prompt", type=str, default="")
    p.add_argument("--for_steps", type=int, default=100)
    p.add_argument("--inv_steps", type=int, default=100)
    p.add_argument("--guidance_scale", type=float, default=0)
    p.add_argument("--edit_prompt", type=str, default="")
    p.add_argument("--edit_t", type=float, default=1.0)
    p.add_argument("--x_space_guidance_edit_step", type=float, default=1)
    p.add_argument("--x_space_guidance_scale", type=float, default=0)
    p.add_argument("--x_space_guidance_num_step", type=int, default=0)
    p.add_argument("--xsg_pair_impl", type=str, default="batch",
                   choices=["batch", "split"])
    p.add_argument("--pca_rank", type=int, default=2)
    p.add_argument("--op", type=str, default="mid", choices=["down", "mid", "up"])
    p.add_argument("--block_idx", type=int, default=0)
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "xla", "flash"],
                   help="'auto' = flash on cuda, xla on cpu")
    p.add_argument("--pullback_attn_impl", type=str, default="",
                   choices=["", "xla", "flash"],
                   help="attention inside the differentiated encoder: "
                        "'flash' = the fused JVP/VJP kernel pair, 'xla' = "
                        "the math path; '' = flash on cuda, xla on cpu")
    p.add_argument("--run_edit_local_encoder_pullback_zt", type=str2bool,
                   default=False)
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def build_sd(args):
    """The SD 2.1-base editing driver: U-Net, VAE at 512 px and the 23-layer
    OpenCLIP-H text tower with seeded random weights."""
    from .experiments import EditStableDiffusion, SDExperimentConfig
    from .models import (
        AutoencoderKL,
        CLIPTextModel,
        UNet2DCondition,
        random_init_,
        sd21_base_unet,
        sd21_text_encoder,
        sd_vae,
    )
    from .ops.schedule import DiffusionSchedule
    from .utils.datasets import NoiseDataset
    from .utils.device import resolve_device
    from .utils.logging import JSONLLogger

    device = resolve_device(args.device or None)
    on_cuda = device.type == "cuda"
    dtype = args.dtype or ("bf16" if on_cuda else "fp32")
    attn = args.attn_impl if args.attn_impl != "auto" else (
        "flash" if on_cuda else "xla")

    unet = random_init_(UNet2DCondition(sd21_base_unet(
        attn_impl=attn, dtype="bfloat16" if dtype == "bf16" else "float32")),
        args.seed)
    vae = random_init_(AutoencoderKL(sd_vae(attn_impl=attn)), args.seed + 1)
    text = random_init_(CLIPTextModel(sd21_text_encoder()), args.seed + 2)

    exp_folder = os.path.join(args.result_folder,
                              f"Stable_Diffusion-{DATASET}-{args.note}")
    cfg = SDExperimentConfig(
        dataset_name=DATASET,
        for_steps=args.for_steps,
        inv_steps=args.inv_steps,
        edit_t=args.edit_t,
        seed=args.seed,
        guidance_scale=args.guidance_scale,
        for_prompt=args.for_prompt,
        neg_prompt=args.neg_prompt,
        inv_prompt=args.inv_prompt,
        edit_prompt=args.edit_prompt,
        x_space_guidance_edit_step=args.x_space_guidance_edit_step,
        x_space_guidance_scale=args.x_space_guidance_scale or 1.0,
        x_space_guidance_num_step=args.x_space_guidance_num_step or 16,
        xsg_pair_impl=args.xsg_pair_impl,
        pca_rank=args.pca_rank,
        # the fused pair by default on the card, as the JAX CLI on an
        # accelerator; --pullback_attn_impl xla opts out
        pullback_attn_impl=args.pullback_attn_impl or (
            "flash" if on_cuda else "xla"),
        result_folder=os.path.join(exp_folder, "results"),
        basis_folder=os.path.join(
            "./inputs",
            f"local_encoder_pullback_stable_diffusion-dataset_{DATASET}"
            f"-num_steps_{args.for_steps}-pca_rank_{args.pca_rank}"),
    )
    return EditStableDiffusion(
        unet, vae, text, DiffusionSchedule.from_name("scaled_linear"),
        NoiseDataset(unet.config.sample_size * 8), cfg,
        logger=JSONLLogger(os.path.join(exp_folder, "log.jsonl")),
        device=device)


def main(argv=None):
    args = parse_args(argv)
    edit = build_sd(args)
    if args.run_edit_local_encoder_pullback_zt:
        edit.run_edit_local_encoder_pullback_zt(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
            vis_num=4, vis_num_pc=2, pca_rank=args.pca_rank or 2,
            edit_prompt=args.edit_prompt or None)
    return edit


if __name__ == "__main__":
    main(sys.argv[1:])
