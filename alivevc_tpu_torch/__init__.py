"""alivevc_tpu_torch — the PyTorch/CUDA port of alivevc_tpu.

Same layout as the JAX package (``ops/``, ``nn/``, ``models/``,
``kernels/``, ``infer/``, ``compat/``), channels-last tensors ``[N, T, C]``
at every public function, and hand-written CUDA kernels for Hopper in
``csrc/`` where the JAX package has a Pallas kernel.  Nothing here imports
JAX or the JAX package.
"""
