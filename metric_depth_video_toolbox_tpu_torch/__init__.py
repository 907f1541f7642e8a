"""PyTorch / CUDA port of the metric depth video toolbox.

A second package beside the JAX reference ``metric_depth_video_toolbox_tpu``.
It imports ``torch`` and never ``jax``; every Pallas kernel on a ported
path is a hand-written CUDA kernel under ``csrc/`` with a plain PyTorch
twin beside its wrapper. Entry points run on the CUDA device unless the
caller asks for the CPU (``device="cpu"`` or ``MDVT_PLATFORM=cpu``).
"""
