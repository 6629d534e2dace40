"""Inverse rendering through the path tracer (mirror of ``rvpt_tpu/train``)."""
