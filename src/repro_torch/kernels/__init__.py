"""Hand-written Hopper kernels of the serving decode path and the model's
prefill.

Each kernel package (mla_decode, softmax_merge, delta_rotate, sparse_select,
flash_prefill, ssd_chunk) holds:

* ops.py — the wrapper. On CUDA tensors it checks device, dtype, shape and
  strides, allocates its outputs with torch.empty, launches the CUDA kernel
  from csrc/<name>.cu on the current stream (no synchronisation) and adds
  one to its `launches` counter and to its card's entry of
  `launches_by_card` (a Counter keyed by the card's index). flash_prefill
  has two kernels and picks one by the operands' dtype:
  csrc/flash_prefill.cu for f32, csrc/flash_prefill_bf16.cu for bf16
  (counted apart in `launches_by_dtype`, and `launches_by_card` by dtype
  then card). On CPU tensors it runs the plain version.
  Anything else raises; nothing falls back.
* ref.py — the plain PyTorch version of the same function, which the CPU
  tests run and the chip smoke test holds the kernel against.

csrc/ holds the CUDA C++ sources (sm_90a, plain C interface); build.py
compiles them with nvcc on first use and loads them with ctypes.
"""
