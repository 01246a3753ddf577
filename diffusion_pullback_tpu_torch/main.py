"""Command-line entry point of the port: the SD 2.1-base, SDXL-base,
DDPM-family (CelebA-HQ-256 and the other '*_HF' names) and ADM-family
(ImageNet256Uncond, LSUN_*, *_P2, …) subsets of the JAX package's main.py,
with the same flag names, experiment folders and basis folders.

    python -m diffusion_pullback_tpu_torch.main --note smoke \\
        --run_edit_local_encoder_pullback_zt True
    python -m diffusion_pullback_tpu_torch.main --note with_prompt \\
        --edit_prompt "sitting dog" --pullback_guidance_scale 7.5 \\
        --edit_t 0.7 --run_edit_local_encoder_pullback_zt True
    python -m diffusion_pullback_tpu_torch.main --note smoke \\
        --model_name stabilityai/stable-diffusion-xl-base-1.0 \\
        --edit_t 0.5 --run_edit_local_encoder_pullback_zt True
    python -m diffusion_pullback_tpu_torch.main --note smoke \\
        --model_name CelebA_HQ_HF --dataset_name CelebA_HQ \\
        --performance_boosting_t 0.2 --run_edit_local_encoder_pullback_zt True
    python -m diffusion_pullback_tpu_torch.main --note guided \\
        --model_name ImageNet256Uncond --performance_boosting_t 0.2 \\
        --classifier_scale 2.5 --sampling_timesteps ddim25 \\
        --run_edit_local_encoder_pullback_zt True
    python -m diffusion_pullback_tpu_torch.main --note harvest \\
        --run_sample_encoder_local_tangent_space_zt True
    python -m diffusion_pullback_tpu_torch.main --note prompts --edit_t 0.5 \\
        --num_local_basis 50 \\
        --run_edit_local_encoder_pullback_zt_with_various_prompt True
    python -m diffusion_pullback_tpu_torch.main --note h --model_name \\
        ImageNet256Uncond --performance_boosting_t 0.2 \\
        --checkpoint_path 256x256_diffusion_uncond.pt \\
        --run_edit_h_space_guidance True

On a device mesh, one rank per device through torchrun (NCCL on CUDA,
gloo with ``--device cpu``; rank 0 writes the run's files):

    torchrun --nproc_per_node 4 -m diffusion_pullback_tpu_torch.main \\
        --note mesh --mesh_axes dp:2,probe:2 \\
        --run_sample_encoder_local_tangent_space_zt True

Runs on CUDA unless ``--device cpu`` is given. Without --checkpoint_path
the models take seeded random weights (--seed), as the JAX CLI's do; with
it they load local torch files (nothing is downloaded): one file for an
uncond model, a diffusers folder (unet/, vae/, text_encoder/ and, for
SDXL, text_encoder_2/) for the SD family; --classifier_path is the
guidance classifier's file. ``--model_name`` defaults to SD 2.1-base,
where the JAX CLI's '' default raises. An uncond net edits images at its
own size and is guided by adm_classifier at that size, where the JAX
CLI's preset takes 256 px for every name without CIFAR10 (32 px): the two
differ for ImageNet64Uncond, ImageNet64Cond and ImageNet128Cond, and
build_uncond says so when it builds one of them.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys

from .configs import X_SPACE_GUIDANCE_SCALE_DICT

SD_MODEL = "stabilityai/stable-diffusion-2-1-base"
SDXL_MODEL = "stabilityai/stable-diffusion-xl-base-1.0"

# the t grid of --run_sample_encoder_local_tangent_space_zt: 1.0, 0.95, …, 0.05
HARVEST_T_GRID = tuple(reversed([round(0.05 * i, 2) for i in range(1, 21)]))


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diffusion_pullback_tpu_torch.main",
        epilog="The JAX CLI's --loop_impl, --loop_chunk and --weights_dtype "
               "choose how its compiled programs loop and in which dtype its "
               "weights sit on a 16 GB TPU chip; the port compiles no "
               "programs, runs eagerly on the card and has no such flags.")
    p.add_argument("--note", type=str, required=True)
    p.add_argument("--model_name", type=str, default=SD_MODEL,
                   help=f"{SD_MODEL}, {SDXL_MODEL} or an uncond name: "
                        "CelebA_HQ_HF, LSUN_church_HF, LSUN_bedroom_HF, FFHQ_HF "
                        "(DDPM U-Net) or an ADM one (ImageNet256Uncond, "
                        "LSUN_bedroom, FFHQ_P2, CIFAR10, …)")
    p.add_argument("--dataset_name", type=str, default="",
                   help="an image folder under datasets/ (or --data_root); "
                        "'' or 'noise' = seeded noise images")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--sample_idx", type=int, default=0)
    p.add_argument("--sample_idx_0", type=int, default=0,
                   help="run_edit_parallel_transport: the sample whose directions move")
    p.add_argument("--sample_idx_1", type=int, default=0,
                   help="run_edit_parallel_transport: the sample edited along them")
    p.add_argument("--checkpoint_path", type=str, default="",
                   help="local torch weights (.bin/.pt/.ckpt, or .safetensors "
                        "with the safetensors package): an uncond model's one "
                        "file, or the SD family's diffusers folder (unet/, vae/, "
                        "text_encoder/, text_encoder_2/ for SDXL); '' = seeded "
                        "random init")
    p.add_argument("--classifier_path", type=str, default="",
                   help="the guidance classifier's torch file (guided-diffusion "
                        "EncoderUNetModel layout); '' = seeded random init")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="",
                   help="'' = cuda (raises without a card); 'cpu' to force")
    p.add_argument("--dtype", type=str, default="", choices=["", "fp32", "bf16"],
                   help="U-Net compute/weight dtype; '' = bf16 on cuda, fp32 "
                        "on cpu (the VAE and text towers stay fp32)")
    p.add_argument("--result_folder", type=str, default="./runs/")
    p.add_argument("--for_prompt", type=str, default="")
    p.add_argument("--inv_prompt", type=str, default="")
    p.add_argument("--neg_prompt", type=str, default="")
    p.add_argument("--for_steps", type=int, default=100)
    p.add_argument("--inv_steps", type=int, default=100)
    p.add_argument("--performance_boosting_t", type=float, default=0.0)
    p.add_argument("--guidance_scale", type=float, default=0)
    p.add_argument("--edit_prompt", type=str, default="")
    p.add_argument("--edit_t", type=float, default=1.0)
    p.add_argument("--use_x_space_guidance", type=str2bool, default=False,
                   help="take --x_space_guidance_scale from the h_t table")
    p.add_argument("--h_t", type=float, default=0.8)
    p.add_argument("--x_space_guidance_edit_step", type=float, default=1)
    p.add_argument("--x_space_guidance_scale", type=float, default=0)
    p.add_argument("--x_space_guidance_num_step", type=int, default=0)
    p.add_argument("--edit_ht", type=str, default="default",
                   help="'h_space_guidance' runs run_edit_h_space_guidance")
    p.add_argument("--h_space_guidance_scale", type=float, default=0.0,
                   help="h-space guidance's scale; 0 = --x_space_guidance_scale")
    p.add_argument("--xsg_pair_impl", type=str, default="auto",
                   choices=["auto", "batch", "split"],
                   help="the walk's (null, edit) pair: 'batch' = one 2·B U-Net "
                        "call, 'split' = two B-row calls; 'auto' = batch for the "
                        "SD family, split for the pixel-space nets (the JAX "
                        "CLI's mapping)")
    p.add_argument("--pca_rank", type=int, default=2)
    p.add_argument("--pullback_chunk_size", type=int, default=0,
                   help="probes per tangent/cotangent batch; 0 = all (SDXL: "
                        "all at pca_rank <= 2, else 1)")
    p.add_argument("--pullback_guidance_scale", type=float, default=0.0,
                   help="SD path: CFG inside the JVP'd encoder (BASELINE "
                        "config 4): >0 differentiates h_edit + s*(h_edit - "
                        "h_neg) as a fused 2B batch; 0 = edit-prompt encoder "
                        "alone")
    p.add_argument("--edit_deepcache_interval", type=int, default=0,
                   help="SD path: DeepCache on the edit's finish sampling, "
                        "refresh the deep U-Net path every N steps; 0/1 = "
                        "the full model every step")
    p.add_argument("--guidance_deepcache_interval", type=int, default=0,
                   help="SD path: DeepCache on the x-space-guidance walk's "
                        "[z; z+dv] pair, refresh every N micro-steps; 0/1 = "
                        "the full pair every micro-step")
    p.add_argument("--text_driven_num_pc", type=int, default=0,
                   help="run_edit_text_driven_direction: 0 = one J^T dh "
                        "direction; k>0 = dh decomposed in the top-k pullback "
                        "basis, each PC walked separately, signed toward dh")
    p.add_argument("--use_dynamic_thresholding", type=str2bool, default=False,
                   help="clamp each walk frame at the q-quantile of its |x| "
                        "before the finish")
    p.add_argument("--dynamic_thresholding_q", type=float, default=0.8)
    p.add_argument("--use_preserve_contrast", type=str2bool, default=False,
                   help="match each walk frame's mean and std to the walk's start")
    p.add_argument("--use_preserve_norm", type=str2bool, default=False,
                   help="rescale each walk frame to the walk start's norm")
    p.add_argument("--use_sega_reg", type=str2bool, default=False,
                   help="uncond: zero the components of an h-basis edit "
                        "direction below sega_reg_sigma · its std")
    p.add_argument("--sega_reg_sigma", type=float, default=1.0)
    p.add_argument("--op", type=str, default="mid", choices=["down", "mid", "up"])
    p.add_argument("--block_idx", type=int, default=0)
    p.add_argument("--after_res", type=str2bool, default=False)
    p.add_argument("--after_sa", type=str2bool, default=False)
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "xla", "blockwise", "flash", "ring"],
                   help="sampling attention of the SD and ADM nets: 'auto' = "
                        "ring with an 'sp' axis in --mesh_axes, else flash on "
                        "cuda, xla on cpu (the DDPM U-Net's ≤256-token "
                        "attention is always the math path); 'ring' = "
                        "sequence parallel over the mesh's 'sp' axis (K2 per "
                        "ring step on cuda)")
    p.add_argument("--mesh_axes", type=str, default="",
                   help="the device mesh of a torchrun launch: 'probe' | 'dp' | "
                        "'dp:2,probe:4' | 'tp:2' | 'sp:4' (axis[:size], sizes "
                        "factored over the ranks where one is missing); NCCL on "
                        "cuda, gloo with --device cpu; '' or one rank = none")
    p.add_argument("--pullback_attn_impl", type=str, default="",
                   choices=["", "xla", "blockwise", "flash"],
                   help="attention inside the differentiated encoder: "
                        "'flash' = the fused JVP/VJP kernel pair, 'xla' = "
                        "the math path; '' = flash on cuda, else the model's "
                        "own")
    p.add_argument("--classifier_scale", type=float, default=0.0,
                   help="uncond path: classifier guidance scale; > 0 guides "
                        "every sampler loop with the gradient of a noisy-image "
                        "classifier (adm_classifier at the model's size, "
                        "seeded random weights, seed + 1)")
    p.add_argument("--classifier_label", type=int, default=0,
                   help="target class y of classifier guidance")
    p.add_argument("--sampling_timesteps", type=str, default="",
                   help="uncond path: OpenAI respacing grid ('ddim25', '250', "
                        "'25,25,25'); '' = the linspace grid of --for_steps")
    p.add_argument("--run_edit_local_encoder_pullback_zt", type=str2bool,
                   default=False)
    p.add_argument("--run_edit_local_decoder_pullback_zt", type=str2bool,
                   default=False)
    p.add_argument("--run_edit_local_x0_decoder_pullback_zt", type=str2bool,
                   default=False)
    p.add_argument("--run_edit_text_driven_direction", type=str2bool,
                   default=False)
    p.add_argument("--run_ddim_forward", type=str2bool, default=False)
    p.add_argument("--vis_psd", type=str2bool, default=False,
                   help="uncond --run_ddim_forward: also plot the radial power "
                        "spectra of the x_t and eps_t trajectories into obs/")
    p.add_argument("--run_ddim_inversion", type=str2bool, default=False)
    p.add_argument("--run_edit_h_space_guidance", type=str2bool, default=False,
                   help="uncond: walk the tapped feature along the basis' "
                        "h-directions")
    p.add_argument("--run_edit_parallel_transport", type=str2bool, default=False,
                   help="uncond: edit --sample_idx_1 along the pca_rank-50 "
                        "directions of --sample_idx_0, transported")
    # the harvests and the PCA / mean-basis runs
    p.add_argument("--run_edit_local_encoder_pullback_zt_with_various_prompt",
                   type=str2bool, default=False,
                   help="harvest one basis per prompt of the bundled captions "
                        "(--num_local_basis of them, 5 when 0), then edit with each")
    p.add_argument("--various_prompt_sample_idx", type=int, default=0,
                   help="the prompt sweep's sample; 0 = --sample_idx")
    p.add_argument("--num_local_basis", type=int, default=100,
                   help="prompts of the prompt sweep, latents of global PCA, "
                        "samples (at most 5) of the mean-basis edits")
    p.add_argument("--run_edit_global_pca_zt", type=str2bool, default=False)
    p.add_argument("--run_edit_local_pca_zt", type=str2bool, default=False)
    p.add_argument("--run_sample_encoder_local_tangent_space_zt", type=str2bool,
                   default=False,
                   help="harvest pca_rank-50 bases over the 20-point t grid "
                        "1.0, 0.95, …, 0.05")
    p.add_argument("--fix_xt", type=str2bool, default=False,
                   help="uncond t-grid harvest: every basis at the first grid "
                        "point's image")
    p.add_argument("--fix_t", type=str2bool, default=False,
                   help="uncond t-grid harvest: every basis at the first grid "
                        "point's timestep")
    p.add_argument("--run_edit_global_frechet_mean_zt", type=str2bool, default=False,
                   help="uncond: edit along the Frechet mean of the first "
                        "min(num_local_basis, 5) samples' bases at pca_rank 10")
    p.add_argument("--run_edit_global_hungarian_mean_zt", type=str2bool,
                   default=False,
                   help="uncond: as the Frechet run, with the Hungarian-matched "
                        "mean")
    # the rest of the JAX CLI's flags, with its types and defaults
    p.add_argument("--sh_file_name", type=str, default="",
                   help="a script under ./scripts, copied into the experiment "
                        "folder")
    p.add_argument("--use_yh_custom_scheduler", type=str2bool, default=True,
                   help="the linspace DDIM grid; False is refused, as the JAX "
                        "CLI asserts")
    p.add_argument("--matmul_precision", type=str, default="",
                   choices=["", "highest"],
                   help="f32 products on the card are always full f32 "
                        "(TF32 off), the JAX CLI's 'highest'")
    p.add_argument("--debug_nans", type=str2bool, default=False,
                   help="raise at the first backward op that makes a NaN "
                        "(torch.autograd.detect_anomaly; the forward and the "
                        "tangent passes are not checked)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace (host ops and, on the card, "
                        "device kernels) of the whole run into this folder; '' = "
                        "none")
    p.add_argument("--aot_export", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="'on': the per-step ε of the DDIM loops and the VAE "
                        "encode / decode as torch.export programs stored under "
                        ".torch_cache/exports and loaded by later runs; 'off' "
                        "runs them eagerly; 'auto' is eager in the port (the "
                        "JAX CLI's 'auto' exports on an accelerator, where a "
                        "process re-traces its programs; an eager process has "
                        "no trace to skip)")
    for flag, kind, default in INERT_FLAGS:
        p.add_argument(f"--{flag}", type=kind, default=default,
                       help="accepted and unused, as in the JAX CLI")
    return p


# flags the JAX CLI accepts and never reads (or overwrites in its preset:
# image_size and c_in), with its types and defaults
INERT_FLAGS = (
    ("num_imgs", int, 100), ("image_size", int, 256), ("c_in", int, 3),
    ("edit_xt", str, "default"), ("x_space_guidance_use_edit_prompt", str2bool, True),
    ("no_edit_t", float, 0.5), ("h_edit_step_size", float, 0),
    ("x_edit_step_size", float, 0), ("pca_device", str, "cpu"),
    ("buffer_device", str, "cpu"), ("save_result_as", str, "image"),
    ("various_prompt_type", str, ""), ("frechet_mean_space", str, ""),
    ("hungarian_mean_space", str, ""),
    *((flag, str2bool, False) for flag in (
        "run_cfg_forward", "run_mcg_forward", "run_pfg_forward", "local_projection",
        "debug_mode", "sampling_mode")),
)


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def is_stable_diffusion(args) -> bool:
    return "stable-diffusion" in args.model_name


def is_sdxl(args) -> bool:
    return is_stable_diffusion(args) and "-xl-" in args.model_name


def experiment_folders(args):
    """(experiment folder, basis folder) as the JAX CLI names them for the
    same flags: ``preset`` in utils/config.py and the builders of main.py."""
    if is_sdxl(args):
        exp = f"Stable_Diffusion_XL-{args.dataset_name}-{args.note}"
        family = "sdxl"
    elif is_stable_diffusion(args):
        exp = f"Stable_Diffusion-{args.dataset_name}-{args.note}"
        family = "stable_diffusion"
    else:
        exp = f"{args.model_name}-{args.dataset_name}-{args.note}"
        family = "uncond"
    basis = os.path.join(
        "./inputs", f"local_encoder_pullback_{family}-dataset_{args.dataset_name}"
                    f"-num_steps_{args.for_steps}-pca_rank_{args.pca_rank}")
    return os.path.join(args.result_folder, exp), basis


def xsg_pair_impl(args) -> str:
    """--xsg_pair_impl with 'auto' resolved as the JAX CLI's preset does:
    batch for the SD family's latents, split for the pixel-space nets."""
    if args.xsg_pair_impl != "auto":
        return args.xsg_pair_impl
    return "batch" if is_stable_diffusion(args) else "split"


def _guidance_scale(args, default: float) -> float:
    scale = args.x_space_guidance_scale
    if args.use_x_space_guidance:
        family = "stable-diffusion" if is_stable_diffusion(args) else "uncond"
        scale = X_SPACE_GUIDANCE_SCALE_DICT[family][args.h_t]
    return scale or default


def _dataset(args, image_size: int):
    from .utils.datasets import NoiseDataset, get_dataset

    try:
        return get_dataset(args.dataset_name or "noise", image_size,
                           args.data_root or None)
    except FileNotFoundError as e:
        print(f"[main] {e}; falling back to offline noise dataset")
        return NoiseDataset(image_size)


def _weights(module, path: str, seed: int):
    """``module`` with the torch checkpoint at ``path`` loaded, or with
    seeded random weights where no path is given."""
    from .models import random_init_
    from .models.convert import load_torch_checkpoint

    if not path:
        return random_init_(module, seed)
    return load_torch_checkpoint(path, module)


def build_uncond(args, mesh=None):
    """The uncond editing driver: the DDPM or ADM U-Net of ``--model_name``
    with the weights of --checkpoint_path or seeded random ones, drawn or
    loaded on the device, the linear schedule, images at the model's size;
    with --classifier_scale the guidance classifier adm_classifier(size)
    (--classifier_path, else seeded seed + 1) in f32 with the math path's
    attention (the JAX CLI's), kept as the driver's ``classifier``. The JAX
    CLI takes images and classifier at its preset size instead (32 px for
    names with CIFAR10, else 256); where the two differ, build_uncond
    prints so."""
    import torch

    from .experiments import EditUncondDiffusion, UncondExperimentConfig
    from .models import model_for_name
    from .ops.schedule import DiffusionSchedule
    from .utils.device import resolve_device
    from .utils.logging import JSONLLogger

    device = resolve_device(args.device or None)
    on_cuda = device.type == "cuda"
    dtype = args.dtype or ("bf16" if on_cuda else "fp32")
    # the sampling kernel of an ADM net ('' keeps its config's math path)
    attn = args.attn_impl if args.attn_impl != "auto" else ("flash" if on_cuda else "")
    if not args.checkpoint_path:
        print("[main] no --checkpoint_path: deterministic random init (offline)")
    with torch.device(device):
        model = _weights(model_for_name(
            args.model_name, dtype="bfloat16" if dtype == "bf16" else "float32",
            attn_impl=attn), args.checkpoint_path, args.seed)
    size = getattr(model.config, "sample_size", None) or model.config.image_size
    jax_size = 32 if "CIFAR10" in args.model_name else 256
    if size != jax_size:
        print(f"[main] {args.model_name}: images and the guidance classifier at the "
              f"model's {size} px; the JAX CLI's preset takes {jax_size} px (a "
              "deliberate departure)")
    exp_folder, basis_folder = experiment_folders(args)
    cfg = UncondExperimentConfig(
        dataset_name=args.dataset_name or "noise",
        for_steps=args.for_steps,
        inv_steps=args.inv_steps,
        edit_t=args.edit_t,
        seed=args.seed,
        x_space_guidance_edit_step=args.x_space_guidance_edit_step,
        x_space_guidance_scale=_guidance_scale(args, 0.1),
        x_space_guidance_num_step=args.x_space_guidance_num_step or 16,
        h_space_guidance_scale=args.h_space_guidance_scale,
        xsg_pair_impl=xsg_pair_impl(args),
        aot_export=args.aot_export,
        performance_boosting_t=args.performance_boosting_t,
        use_performance_boosting=args.performance_boosting_t > 0,
        pca_rank=args.pca_rank,
        pullback_chunk_size=args.pullback_chunk_size or None,
        # the fused pair on the card, as the JAX CLI on an accelerator; at
        # the DDPM nets' ≤256 tokens every impl is the math path anyway
        pullback_attn_impl=args.pullback_attn_impl or ("flash" if on_cuda else ""),
        sampling_timesteps=args.sampling_timesteps,
        classifier_scale=args.classifier_scale,
        classifier_label=args.classifier_label,
        use_dynamic_thresholding=args.use_dynamic_thresholding,
        dynamic_thresholding_q=args.dynamic_thresholding_q,
        use_preserve_contrast=args.use_preserve_contrast,
        use_preserve_norm=args.use_preserve_norm,
        use_sega_reg=args.use_sega_reg,
        sega_reg_sigma=args.sega_reg_sigma,
        result_folder=os.path.join(exp_folder, "results"),
        obs_folder=os.path.join(exp_folder, "obs"),
        basis_folder=basis_folder,
        mesh=mesh,
    )
    edit = EditUncondDiffusion(
        model, DiffusionSchedule.from_name("linear"), _dataset(args, size), cfg,
        logger=JSONLLogger(os.path.join(exp_folder, "log.jsonl")), device=device)
    if args.classifier_scale > 0:
        from .experiments._common import to_nchw
        from .models import EncoderUNetADM, adm_classifier
        from .samplers.guidance import classifier_grad_fn

        if not args.classifier_path:
            print("[main] classifier guidance with random-init classifier "
                  "(no --classifier_path)")
        with torch.device(device):
            clf = _weights(EncoderUNetADM(adm_classifier(size)), args.classifier_path,
                           args.seed + 1)
        clf.eval().requires_grad_(False)
        edit.classifier = clf
        edit.cond_fn = classifier_grad_fn(
            lambda z, t: clf(to_nchw(z), t),
            torch.full((1,), args.classifier_label, device=device),
            scale=args.classifier_scale)
    return edit


def _sd_setup(args):
    """(device, U-Net dtype name, attention impl) of an SD-family build."""
    from .utils.device import resolve_device

    device = resolve_device(args.device or None)
    on_cuda = device.type == "cuda"
    dtype = args.dtype or ("bf16" if on_cuda else "fp32")
    attn = args.attn_impl if args.attn_impl != "auto" else (
        "flash" if on_cuda else "xla")
    return device, "bfloat16" if dtype == "bf16" else "float32", attn


def _sd_config(args, device, **over):
    """The SDExperimentConfig of an SD-family build from the flags;
    ``over`` sets the family's own fields."""
    from .experiments import SDExperimentConfig

    exp_folder, basis_folder = experiment_folders(args)
    fields = dict(
        dataset_name=args.dataset_name or "noise",
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
        x_space_guidance_scale=_guidance_scale(args, 1.0),
        x_space_guidance_num_step=args.x_space_guidance_num_step or 16,
        xsg_pair_impl=xsg_pair_impl(args),
        aot_export=args.aot_export,
        pca_rank=args.pca_rank,
        # the fused pair by default on the card, as the JAX CLI on an
        # accelerator; --pullback_attn_impl xla opts out
        pullback_attn_impl=args.pullback_attn_impl or (
            "flash" if device.type == "cuda" else "xla"),
        pullback_chunk_size=args.pullback_chunk_size or None,
        pullback_guidance_scale=args.pullback_guidance_scale,
        edit_deepcache_interval=args.edit_deepcache_interval,
        guidance_deepcache_interval=args.guidance_deepcache_interval,
        text_driven_num_pc=args.text_driven_num_pc,
        use_dynamic_thresholding=args.use_dynamic_thresholding,
        dynamic_thresholding_q=args.dynamic_thresholding_q,
        use_preserve_contrast=args.use_preserve_contrast,
        use_preserve_norm=args.use_preserve_norm,
        result_folder=os.path.join(exp_folder, "results"),
        obs_folder=os.path.join(exp_folder, "obs"),
        basis_folder=basis_folder,
    )
    fields.update(over)
    return SDExperimentConfig(**fields), os.path.join(exp_folder, "log.jsonl")


# the files of a diffusers folder (--checkpoint_path of the SD family)
SD_CHECKPOINT_FILES = ("unet/diffusion_pytorch_model.bin",
                       "vae/diffusion_pytorch_model.bin",
                       "text_encoder/pytorch_model.bin",
                       "text_encoder_2/pytorch_model.bin")


def _sd_weights(args, modules):
    """The SD family's modules (U-Net, VAE, the text towers, in the order
    of SD_CHECKPOINT_FILES) with the weights of the diffusers folder
    --checkpoint_path, or seeded random ones (seed, seed + 1, …)."""
    root = args.checkpoint_path
    if not root:
        print("[main] no --checkpoint_path: deterministic random init (offline)")
    return [_weights(m, root and os.path.join(root, f), args.seed + i)
            for i, (m, f) in enumerate(zip(modules, SD_CHECKPOINT_FILES))]


def build_sd(args, mesh=None):
    """The SD 2.1-base editing driver: U-Net, VAE at 512 px and the 23-layer
    OpenCLIP-H text tower with the weights of --checkpoint_path or seeded
    random ones."""
    from .experiments import EditStableDiffusion
    from .models import (
        AutoencoderKL,
        CLIPTextModel,
        UNet2DCondition,
        sd21_base_unet,
        sd21_text_encoder,
        sd_vae,
    )
    from .ops.schedule import DiffusionSchedule
    from .utils.logging import JSONLLogger

    if is_sdxl(args):
        raise ValueError(f"{args.model_name} is built by build_sdxl")
    device, dtype, attn = _sd_setup(args)
    unet, vae, text = _sd_weights(args, (
        UNet2DCondition(sd21_base_unet(attn_impl=attn, dtype=dtype)),
        AutoencoderKL(sd_vae(attn_impl=attn)), CLIPTextModel(sd21_text_encoder())))
    cfg, log_path = _sd_config(args, device, mesh=mesh)
    return EditStableDiffusion(
        unet, vae, text, DiffusionSchedule.from_name("scaled_linear"),
        _dataset(args, unet.config.sample_size * 8), cfg,
        logger=JSONLLogger(log_path), device=device)


def sdxl_pullback_chunk(args):
    """The SDXL CLI's probes per pullback pass: --pullback_chunk_size, else
    all at once up to pca_rank 2 and one at a time above, as the JAX CLI."""
    return args.pullback_chunk_size or (None if (args.pca_rank or 2) <= 2 else 1)


def build_sdxl(args, mesh=None):
    """The SDXL-base editing driver: the 2.57 B-parameter U-Net at 128²
    latents, the VAE at 1024 px with scaling factor 0.13025, the CLIP ViT-L
    and OpenCLIP bigG towers, with the weights of --checkpoint_path or
    seeded random ones (seeds seed … +3), drawn or loaded on the device the
    models are built on; the JAX CLI's pullback chunking (all probes at
    once up to pca_rank 2, else one at a time), its remat (each transformer
    block recomputed in the backward when the U-Net runs bf16, every
    pullback's vjp taken per cotangent pass) and one latent per VAE
    decode."""
    import torch

    from .experiments import EditStableDiffusionXL
    from .models import (
        AutoencoderKL,
        CLIPTextModel,
        UNet2DCondition,
        sd_vae,
        sdxl_base_unet,
        sdxl_text_encoder_1,
        sdxl_text_encoder_2,
    )
    from .ops.schedule import DiffusionSchedule
    from .utils.logging import JSONLLogger

    device, dtype, attn = _sd_setup(args)
    with torch.device(device):
        unet, vae, text1, text2 = _sd_weights(args, (
            UNet2DCondition(sdxl_base_unet(attn_impl=attn, dtype=dtype,
                                           remat_transformer=dtype == "bfloat16")),
            AutoencoderKL(sd_vae(attn_impl=attn, scaling_factor=0.13025)),
            CLIPTextModel(sdxl_text_encoder_1()),
            CLIPTextModel(sdxl_text_encoder_2(), projection=True)))
    cfg, log_path = _sd_config(args, device, decode_chunk=1, pullback_remat=True,
                               pullback_chunk_size=sdxl_pullback_chunk(args), mesh=mesh)
    return EditStableDiffusionXL(
        unet, vae, text1, text2, DiffusionSchedule.from_name("scaled_linear"),
        _dataset(args, unet.config.sample_size * 8), cfg,
        logger=JSONLLogger(log_path), device=device)


def mesh_spec(spec: str):
    """--mesh_axes → (axes, {axis: size} of the axes that give one)."""
    axes, shape = [], {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            a, n = part.split(":")
            axes.append(a.strip())
            shape[a.strip()] = int(n)
        else:
            axes.append(part)
    return tuple(axes), shape


def build_mesh(args):
    """--mesh_axes 'probe' / 'dp' / 'dp:2,probe:4' → a DeviceMesh over the
    ranks of the torchrun launch ('' or a single rank → None, the
    single-device path, as the JAX CLI with one device visible)."""
    from .parallel.mesh import make_mesh, mesh_shape, world_size

    axes, shape = mesh_spec(getattr(args, "mesh_axes", ""))
    if not axes:
        return None
    if world_size() == 1:
        print("[main] --mesh_axes given but only 1 device visible; "
              "running single-chip")
        return None
    from .utils.device import resolve_device

    mesh = make_mesh(axes, shape=shape if len(shape) == len(axes) else None,
                     device=resolve_device(args.device or None))
    print(f"[main] device mesh: {mesh_shape(mesh)}")
    return mesh


def check_preset(args) -> None:
    """The JAX CLI's preset: its asserts (the custom scheduler; an uncond
    run takes 100 forward steps and boosting at 0.2·T, an SD run no
    boosting), --attn_impl auto as ring when --mesh_axes has an 'sp' axis,
    and the copy of --sh_file_name's script into the experiment folder."""
    if args.attn_impl == "auto" and "sp" in mesh_spec(args.mesh_axes)[0]:
        # an 'sp' axis asks for sequence parallelism: ring attention
        args.attn_impl = "ring"
        print("[preset] --attn_impl auto -> ring (sp mesh axis)")
    if not args.use_yh_custom_scheduler:
        raise ValueError("--use_yh_custom_scheduler False: the JAX CLI asserts it True")
    if is_stable_diffusion(args):
        if args.performance_boosting_t > 0:
            raise ValueError("Stable Diffusion runs take no performance "
                             "boosting (--performance_boosting_t 0)")
    elif args.for_steps != 100 or args.performance_boosting_t != 0.2:
        raise ValueError("uncond runs take --for_steps 100 and "
                         "--performance_boosting_t 0.2")
    script = os.path.join("scripts", args.sh_file_name)
    if args.sh_file_name and os.path.exists(script):
        exp_folder = experiment_folders(args)[0]
        os.makedirs(exp_folder, exist_ok=True)
        shutil.copy(script, os.path.join(exp_folder, args.sh_file_name))


def main(argv=None):
    import torch

    from .utils.profiling import trace

    args = parse_args(argv)
    check_preset(args)
    build = build_sdxl if is_sdxl(args) else (
        build_sd if is_stable_diffusion(args) else build_uncond)
    mesh = build_mesh(args)
    with (torch.autograd.detect_anomaly(check_nan=True) if args.debug_nans
          else contextlib.nullcontext()), trace(args.profile_dir):
        edit = build(args) if mesh is None else build(args, mesh=mesh)
        dispatch(edit, args)
    return edit


def dispatch(edit, args) -> None:
    """Run on ``edit`` (a driver the builders made from ``args``) every run
    its flags ask for, in the JAX CLI's order and with its values."""
    sd = is_stable_diffusion(args)
    if args.run_edit_local_encoder_pullback_zt:
        edit.run_edit_local_encoder_pullback_zt(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
            vis_num=4, vis_num_pc=2, pca_rank=args.pca_rank or 2,
            edit_prompt=args.edit_prompt or None,
            after_res=args.after_res, after_sa=args.after_sa)
    if args.run_edit_local_encoder_pullback_zt_with_various_prompt:
        from .utils.datasets import get_prompt_list

        prompts = get_prompt_list(num_captions=args.num_local_basis or 5)
        sweep_idx = args.various_prompt_sample_idx or args.sample_idx
        if hasattr(edit, "run_sample_encoder_local_tangent_space_zt_various_prompt"):
            # fills the basis cache of every prompt, so the edits below
            # run no pullback
            edit.run_sample_encoder_local_tangent_space_zt_various_prompt(
                prompts, idx=sweep_idx, op=args.op, block_idx=args.block_idx,
                pca_rank=args.pca_rank or 2)
        for prompt in prompts:
            edit.run_edit_local_encoder_pullback_zt(
                idx=sweep_idx, op=args.op, block_idx=args.block_idx, vis_num=4,
                vis_num_pc=2, pca_rank=args.pca_rank or 2, edit_prompt=prompt)
    if args.run_edit_parallel_transport:
        if not hasattr(edit, "run_edit_parallel_transport"):
            raise SystemExit("--run_edit_parallel_transport is only implemented for "
                             "the unconditional family")
        edit.run_edit_parallel_transport(
            sample_idx_0=args.sample_idx_0, sample_idx_1=args.sample_idx_1,
            op=args.op, block_idx=args.block_idx, vis_num=4, vis_num_pc=2, pca_rank=50)
    if args.run_edit_local_decoder_pullback_zt or \
            args.run_edit_local_x0_decoder_pullback_zt:
        edit.run_edit_local_decoder_pullback_zt(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
            pca_rank=args.pca_rank or 2,
            x0_pullback=bool(args.run_edit_local_x0_decoder_pullback_zt))
    if args.run_edit_global_pca_zt:
        edit.run_edit_global_pca_zt(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
            pca_rank=args.pca_rank or 2, num_samples=args.num_local_basis or 16)
    if args.run_edit_local_pca_zt:
        edit.run_edit_local_pca_zt(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
            pca_rank=max(args.pca_rank, 4), vis_num=4, vis_num_pc=2)
    if args.run_sample_encoder_local_tangent_space_zt:
        kwargs = dict(idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
                      pca_rank=50, t_grid=HARVEST_T_GRID, after_res=args.after_res,
                      after_sa=args.after_sa)
        if sd:
            edit.run_sample_encoder_local_tangent_space_zt_batched(**kwargs)
        else:
            edit.run_sample_encoder_local_tangent_space_xt_batched(
                fix_xt=args.fix_xt, fix_t=args.fix_t, **kwargs)
    for flag, run in (("run_edit_global_frechet_mean_zt", "run_edit_global_frechet_mean_xt"),
                      ("run_edit_global_hungarian_mean_zt",
                       "run_edit_global_hungarian_mean_xt")):
        if getattr(args, flag):
            if not hasattr(edit, run):
                raise SystemExit(f"--{flag} is only implemented for the "
                                 "unconditional family")
            getattr(edit, run)(
                idx=args.sample_idx, basis_indices=list(range(min(args.num_local_basis, 5))),
                op=args.op, block_idx=args.block_idx, pca_rank=10, vis_num=4,
                vis_num_pc=2)
    if args.run_edit_h_space_guidance or args.edit_ht == "h_space_guidance":
        if not hasattr(edit, "run_edit_h_space_guidance"):
            raise SystemExit("--run_edit_h_space_guidance is implemented on the "
                             "unconditional family")
        edit.run_edit_h_space_guidance(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx,
            pca_rank=args.pca_rank or 2, scale=args.h_space_guidance_scale or None)
    if args.run_edit_text_driven_direction:
        if not sd:
            raise SystemExit(
                "--run_edit_text_driven_direction needs a text-conditioned "
                "model (SD family)")
        edit.run_edit_text_driven_direction(
            idx=args.sample_idx, op=args.op, block_idx=args.block_idx)
    if args.run_ddim_forward:
        save_as = os.path.join(edit.cfg.result_folder, "DDIMforward.png")
        if sd:
            edit.run_DDIMforward(num_samples=5, save_as=save_as)
        else:
            edit.run_ddim_forward(num_samples=5, save_as=save_as,
                                  **({"vis_psd": True} if args.vis_psd else {}))
    if args.run_ddim_inversion:
        (edit.run_DDIMinversion if sd else edit.run_ddim_inversion)(idx=args.sample_idx)


if __name__ == "__main__":
    main(sys.argv[1:])
