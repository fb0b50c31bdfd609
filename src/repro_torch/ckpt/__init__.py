"""repro_torch.ckpt — the checkpoint store (``checkpoint``: save,
restore, manifests, in the reference's format) and elastic re-planning
(``elastic.replan``: a checkpoint restored onto another world;
``elastic.resize_plan``)."""
