"""PyTorch/CUDA port of the MoE-offloading system (``src/repro`` is the
JAX reference it is tested against).

The port imports ``torch``, numpy and the standard library only. Its
layouts at public functions are the JAX package's (``wq [d,H,hd]``,
experts ``[L,E,d,ff]``, KV pool ``[N+1,bs,KV,hd]``), so the tests
compare like with like. Every entry point takes ``device=`` (default
``"cuda"``); a CUDA tensor reaching a kernel wrapper launches the
hand-written Hopper kernel (``kernels/csrc``) or raises, a CPU tensor
takes the kernel's plain PyTorch version.
"""
import torch

# fp32 products stay fp32 on the card: TF32 keeps ~3 decimal digits and
# flips near-tied router top-k choices, which changes the expert union,
# the cache trace and the simulated clock.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
