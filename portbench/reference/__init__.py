"""The plain reference the benchmark judges the port by: plain PyTorch and
NumPy in float32 with TF32 off. It imports neither ``jax`` nor the JAX
package nor anything of ``reni_tpu_torch``, and makes again from the seed,
or from the raw files, whatever the program's set-up derived."""
