"""PyTorch/CUDA port of ``mlx_cuda_distributed_pretraining_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module layout and names so every function has a findable counterpart. It
imports ``torch`` and never ``jax`` or anything of the JAX package.

Ported so far: the continuous-batching serving path (``infer/server.py`` ->
``serve/engine.py`` -> the paged KV pool -> ``serve/batch_step.py`` ->
``models/llama.py`` / ``models/moe.py``), with the grouped expert GEMM as a
hand-written CUDA kernel (``csrc/grouped_matmul.cu``, bound in
``ops/grouped_matmul.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
