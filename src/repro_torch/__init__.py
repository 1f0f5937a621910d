"""ApproxTrain on PyTorch and CUDA: the Hopper port of the ``repro`` package.

The port mirrors the JAX package's module names (``core``, ``kernels``,
``models``, ``configs``, ``data``) so each module's reference is easy to
find.  It imports ``torch`` and numpy only.  Ported: the LUT numerics,
every TPU kernel of the JAX package as a hand-written CUDA kernel for
``sm_90a`` (``kernels/csrc``), AMSim inference and training of the
paper's vision models, and serving and training of the dense and MoE LMs
(granite-3-2b, granite-moe-3b-a800m).

Entry points place tensors on the CUDA card unless the caller asks for
``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
"""
