"""PyTorch / CUDA port of the ftIMM stack for one NVIDIA H100.

A package of its own beside the JAX reference ``repro``, with the same module
tree: configs, the ftIMM GEMM kernels (hand-written CUDA C++ for sm_90a),
the GEMM planner and dispatch, the dense decoder model, and the serving
engine.  It imports torch and numpy, never jax and nothing of ``repro``.

Entry points (``ServeEngine``, ``models.model.init_params``,
``launch.serve``) run on the CUDA card unless the caller passes
``device="cpu"``; with no device given and no card present they raise.
"""
