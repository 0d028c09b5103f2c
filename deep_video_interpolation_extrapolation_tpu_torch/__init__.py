"""PyTorch/CUDA port of ``deep_video_interpolation_extrapolation_tpu``.

The JAX package beside this one is the reference; this package computes the
same functions in PyTorch, with every Pallas kernel of the ported slice
rewritten by hand for Hopper (``csrc/`` CUDA C++, one Triton kernel).

Ported so far, for InterNet with the HRNet coarse model: the serving path
(``serve.forward`` / ``serve.rollout``) and the INTER train and eval steps
(``train/inter.make_train_step`` / ``make_eval_step``), every kernel with
its backward.  Public functions keep the
JAX package's NHWC layout.  Nothing here imports ``jax``, ``flax`` or
``optax``, nor any module of the JAX package, which is the port's test
reference only.
"""

__version__ = "0.1.0"
