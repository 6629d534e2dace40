"""The trainer's and the distributed flow's examples (mirrors of
``examples/*.py``), run as modules: ``python -m
rvpt_tpu_torch.examples.<name> --help``.  Each runs on the card unless
``--device cpu`` is given, and takes ``--size`` and ``--steps`` (or
``--frames``) so that it runs small on the CPU."""
