"""Per-timestep edit-strength tables, keyed by model family × h_t (the
fraction of T at which h is tapped): this package's copy of the tables in
diffusion_pullback_tpu/configs/params.py. X_SPACE_GUIDANCE_SCALE_DICT gives
the CLI's --x_space_guidance_scale under --use_x_space_guidance."""

X_SPACE_GUIDANCE_SCALE_DICT = {
    "stable-diffusion": {
        1.0: 0.5, 0.9: 0.5, 0.8: 1, 0.7: 1, 0.6: 2,
        0.5: 2, 0.4: 2, 0.3: 2, 0.2: 2, 0.1: 2, 0.0: 0,
    },
    "uncond": {1.0: 0.5, 0.8: 1, 0.6: 4, 0.4: 16, 0.2: 16},
}

X_SPACE_EDIT_STEP_SIZE_DICT = {
    "stable-diffusion": {
        1.0: 0.5, 0.9: 0.5, 0.8: 1, 0.7: 1, 0.6: 2,
        0.5: 2, 0.4: 2, 0.3: 2, 0.2: 2, 0.1: 2, 0.0: 0,
    },
    "uncond": {1.0: 0.5, 0.8: 1, 0.6: 4, 0.4: 16, 0.2: 16},
}
