"""Named edit prompts for the text-conditioned (SD) experiments: this
package's copy of diffusion_pullback_tpu/configs/prompts.py."""

EDIT_PROMPTS = {
    "dog_sitting": "a photo of a sitting dog",
    "tiger": "a photo of a tiger",
    "smile": "a photo of a smiling face",
    "old": "a photo of an old person",
    "young": "a photo of a young person",
    "glasses": "a photo of a person wearing glasses",
    "church": "a photo of a church",
    "snow": "a photo in the snow",
}
