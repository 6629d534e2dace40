"""Faults planted under the timed path, for the checks' own proof: each
must make a run come out not correct.  ``plant(kind, loop, fault)``
patches the port's module attributes (undo with ``undo``); the loops look
them up at call time.  ``calibrate.py --fault`` reads them at a cell's
size on the card; the CPU tests at a small film.

* ``unchanged``: a draw that returns the film unchanged, or a step whose
  optimizer does not move the parameters;
* ``half``: half of the batch left out, the mean taken over the rest (the
  left half of the image's pixels dropped, the right half doubled);
* ``altered``: the image altered by 1% where it is produced.

(One chip: no exchange between chips to leave out.)"""

from __future__ import annotations

FAULTS = ("unchanged", "half", "altered")


def _halve(img):
    out = img.clone()
    w = out.shape[-1]
    out[..., : w // 2] = 0.0
    out[..., w // 2:] *= 2.0
    return out


def _display(fault):
    import rvpt_tpu_torch.renderer as renderer
    from rvpt_tpu_torch.ops import film as film_ops

    real = renderer.render_frame

    def broken(scene, camera, settings, cfg, film, dirty, **kw):
        if fault == "unchanged" and film.frame > 0:
            return film, film.accum
        new, _ = real(scene, camera, settings, cfg, film, dirty, **kw)
        n = 0 if dirty else film.frame
        sample = new.accum * (n + 1) - (film.accum * n if n else 0.0)
        sample = _halve(sample) if fault == "half" else sample * 1.01
        new = film_ops.accumulate(film, sample, dirty)
        return new, new.accum

    return [(renderer, "render_frame", broken)]


def _train(fault):
    import torch

    import rvpt_tpu_torch.train.inverse as inverse

    if fault == "unchanged":
        return [(torch.optim.Adam, "step", lambda self, closure=None: None)]
    real_make = inverse._make_fast_render

    def make(*a, **kw):
        render = real_make(*a, **kw)

        def broken(s, cam, frame):
            img = render(s, cam, frame)
            return _halve(img) if fault == "half" else img * 1.01

        return broken

    return [(inverse, "_make_fast_render", make)]


def plant(loop: str, fault: str) -> list:
    """Patch the fault in for a ``loop`` ("display" or "train"); returns what
    ``undo`` restores."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    patches = (_display if loop == "display" else _train)(fault)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, new in patches:
        setattr(obj, name, new)
    return saved


def undo(saved: list) -> None:
    for obj, name, old in saved:
        setattr(obj, name, old)
