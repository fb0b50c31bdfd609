"""repro_torch.ckpt — checkpoint helpers of the port (``elastic.resize_plan``
so far; the checkpoint store itself comes with the training slice)."""
