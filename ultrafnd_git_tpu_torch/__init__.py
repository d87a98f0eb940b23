"""PyTorch + CUDA port of ultrafnd_git_tpu for one NVIDIA H100.

Serves a `--train_text_tower` checkpoint exported from the JAX package
(`scripts/export_torch_model.py`) through `serving.Predictor` (f32, bf16 or
int8 weights, dense or sparse graph, with `explain`) and over HTTP
(`serve.py`, `server.py`), with the tower's attention on the hand-written
Hopper kernels in `csrc/flash_attention_fwd.cu` and, under bf16,
`csrc/flash_attention_fwd_bf16.cu`; and trains one (`train.py`). Imports torch,
never jax, and nothing of the JAX package `ultrafnd_git_tpu`: the host
ops it shares with it (hashing, OCR tokens, the Jaccard graph, the C++
host ops in `native/`) are its own copies.
"""
