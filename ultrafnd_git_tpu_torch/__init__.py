"""PyTorch + CUDA port of ultrafnd_git_tpu for one NVIDIA H100.

Serves a `--train_text_tower` checkpoint exported from the JAX package
(`scripts/export_torch_model.py`) through `serving.Predictor`, with the
tower's attention on the hand-written Hopper kernel in
`csrc/flash_attention_fwd.cu`. Imports torch, never jax.
"""
