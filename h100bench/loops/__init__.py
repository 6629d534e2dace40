"""Loops, one file per kind of user: ``Loop(cfg, traffic, seed, device,
scene_fn)`` with ``setup``, ``iterate``, ``drain``, ``frames``,
``intervals_ms``, ``close``, ``check`` and ``census``."""
