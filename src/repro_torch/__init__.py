"""PyTorch + CUDA port of the LUT-GEMM reproduction (``src/repro`` is the JAX
reference).

The package mirrors the reference's module layout (``core``, ``kernels``,
``models``, ``quant``, ``infer``, ``launch``) so each module's counterpart is
found by name. Quantized linears on the GPU run through hand-written CUDA
kernels for Hopper (``csrc/``, built with ``nvcc`` at first use by
``kernels/_build.py``); on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.

Nothing here imports JAX or the ``repro`` package.
"""
