"""ApproxTrain on PyTorch and CUDA: the Hopper port of the ``repro`` package.

The port mirrors the JAX package's module names (``core``, ``kernels``,
``models``, ``configs``, ``data``) so each module's reference is easy to
find.  It imports ``torch`` and numpy only.  The slice ported so far is
AMSim inference of the paper's vision models: the LUT numerics, the
AMDENSE GEMM and AMCONV2D conv forward kernels (CUDA C++ for ``sm_90a``,
``kernels/csrc``) and LeNet-300-100 / LeNet-5 / resnet-mini.

Entry points place tensors on the CUDA card unless the caller asks for
``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
"""
