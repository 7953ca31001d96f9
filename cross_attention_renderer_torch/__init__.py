"""PyTorch / CUDA port of ``cross_attention_renderer_tpu`` for one NVIDIA H100.

The flagship render at two or three context views: encode the posed
context views with the DPT-hybrid encoder, then render query rays through
epipolar sampling, the latent exchange (a fused exchange epilogue, or at
V=3 the reference-compatible unfused exchange with a fused MLP) and two
rounds of joint (view, sample) attention. The kernels of those paths are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` on
first use; everything else is plain PyTorch. The JAX package stays the reference: this package imports nothing
of it.

Entry points take a ``device`` that defaults to ``"cuda"``; the CPU runs only
when the caller asks for it. On CPU tensors the kernel wrappers run their
plain PyTorch versions; on CUDA tensors they launch the kernels or raise.

Numerics policy (set here, for the whole process, on import):
  * ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``: f32 products and the
    encoder's convolutions stay in full f32;
  * geometry runs in f32 whatever the model type;
  * attention logits and softmax run in f32; the value sum accumulates in
    f32 with the weights cast to the value type;
  * the epilogues' and the fused MLP's matrix products accumulate in f32;
  * parameters are stored in f32 and cast to the model's compute type
    (bf16 on the card) at use, as the JAX package's ``dtype`` fields do.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
