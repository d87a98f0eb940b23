"""Plain references of the benchmark's configurations: plain PyTorch in
float32 with TF32 off (`tf32=True` is the control, the nearest precision
below), written from the models' published descriptions. They import
neither jax, the JAX package nor anything of the port, and take nothing the
port made: the benchmark hands both sides the same inputs and weights."""
