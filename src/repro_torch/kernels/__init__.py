"""Hand-written Hopper kernels of the serving decode path.

Each kernel package (mla_decode, softmax_merge, delta_rotate, sparse_select)
holds:

* ops.py — the wrapper. On CUDA tensors it checks device, dtype, shape and
  strides, allocates its outputs with torch.empty, launches the CUDA kernel
  from csrc/<name>.cu on the current stream (no synchronisation) and adds
  one to its `launches` counter. On CPU tensors it runs the plain version.
  Anything else raises; nothing falls back.
* ref.py — the plain PyTorch version of the same function, which the CPU
  tests run and the chip smoke test holds the kernel against.

csrc/ holds the CUDA C++ sources (sm_90a, plain C interface); build.py
compiles them with nvcc on first use and loads them with ctypes.
"""
