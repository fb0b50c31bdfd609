"""repro_torch.ckpt — the checkpoint store (``checkpoint``: save,
restore, manifests, in the reference's format) and elastic resize plans
(``elastic.resize_plan``; restoring onto a new layout, the reference's
``replan``, comes with the ``torch.distributed`` slice)."""
