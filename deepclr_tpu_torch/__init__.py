"""deepclr_tpu_torch: the PyTorch/CUDA port of deepclr_tpu for NVIDIA Hopper.

Pairwise and sequential DeepCLR inference, and training with the flagship
recipe.  The hot ops run as hand-written CUDA kernels (``csrc/``) on the
card; every kernel has a plain PyTorch twin that CPU tensors run.  Entry
points (``models.build_model``, ``models.ModelInferenceHelper``,
``engine.run_trainer``) run on CUDA unless the caller asks for the CPU.
This package imports neither jax nor the deepclr_tpu package.
"""
