"""Logical-axis sharding rules (port of ``repro.sharding``): the rule
table from logical axis names to mesh axes (``partition``) and its
per-(architecture, shape, mesh) derivation (``profiles``)."""
