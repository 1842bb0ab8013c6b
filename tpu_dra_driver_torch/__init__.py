"""PyTorch/CUDA port of the validation workloads in :mod:`tpu_dra_driver`.

The JAX package stays the reference; this package mirrors its
``workloads/`` tree module for module, keeps its function names,
arguments and tensor layouts, and runs on an NVIDIA H100 with every
Pallas kernel of a ported path rewritten by hand for Hopper. It imports
``torch`` and numpy only, never JAX or anything of ``tpu_dra_driver``.

Entry points that create tensors take ``device`` (default ``"cuda"``)
and raise when CUDA is absent unless the caller asks for ``"cpu"``.
Kernel wrappers dispatch on the tensor's device: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the kernel.
"""
