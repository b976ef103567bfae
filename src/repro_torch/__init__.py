"""OMP2HMPP-style offload planning on PyTorch and CUDA: the port of the
``repro`` package (see ``repro_torch.core``)."""
