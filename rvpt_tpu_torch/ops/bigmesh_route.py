"""The big-mesh route as it ran one launch per bounce or search: the
composition the one-launch route (``BigMeshTracer``, K1's and B3's BVH
forms with the rays passed in) is held against, bit for bit, by
tests/test_torch_bigmesh_fold.py, tests/test_torch_cuda.py and
chip_smoke.py.

``per_bounce`` composes it from a closest-hit ``search`` (by default
``bigmesh_search_plain``; on the card ``BigMeshTracer.search``, B5's
search-only instance) with ``_primary_finalize`` (modes 0-6) or
``_shade_plain`` (7-9) between the searches and ``_finish_plain`` at the
end; Kajiya may instead run one ``bounce`` per bounce on the f32[16, N]
state (``plain_bounce``, ``bigmesh_bounce_plain``; on the card
``BigMeshTracer.bounce``, B5's bounce instance), which gives the same
values.  It goes with B5's per-bounce instances and their plain versions.
"""

from __future__ import annotations

import torch

from . import pathkernel as pk


def plain_search(bt):
    """``search(o3, d3, live=None)`` -> the winner's seven f32/int32[N]
    fields, through ``bigmesh_search_plain`` on ``bt``'s tables."""

    def search(o3, d3, live=None):
        if live is None:
            live = torch.ones_like(o3[0], dtype=torch.bool)
        w, i = pk.bigmesh_search_plain(bt.tables, bt.counts, (*o3, *d3), live,
                                       bt.mint)
        return (*w.unbind(0), *i.unbind(0))

    return search


def plain_bounce(bt):
    """``bounce(pix, state, frame, salt)`` -> the next f32[16, N] state,
    through ``bigmesh_bounce_plain`` on ``bt``'s tables."""

    def bounce(pix, state, frame, salt):
        return pk.bigmesh_bounce_plain(bt.tables, bt.counts, pix, state, frame,
                                       salt, bt.mint)

    return bounce


def per_bounce(bt, mode, pix, rays, frame, salt_base, nb, style="standard",
               nrays=1, search=None, bounce=None, count=pk._no_count):
    """Integrator ``mode`` 0-9 of ``bt`` (a ``BigMeshTracer``) on the six
    f32[N] ray components ``rays`` as the per-bounce route ran it ->
    f32[3, N]: ``search(o3, d3, live)`` for every search (``plain_search``
    when None), Kajiya with ``bounce(pix, state, frame, salt)`` on the
    f32[16, N] state where given; bounce b draws with salt ``salt_base + 4
    b``, AO casts ``nrays`` probes.  ``count(key, mask)`` gets the lanes of
    each kind of work of modes 7-9 as ``trace_plain``'s ``work`` counts
    them."""
    search = search or plain_search(bt)
    mat = bt._mat
    if mode in pk.PRIMARY_MODES:
        winner = search(rays[:3], rays[3:])
        return torch.stack(pk._primary_finalize(mode, nrays, mat, pix, frame,
                                                salt_base, rays, winner, search))
    integ = {7: "whitted", 8: "cook", 9: "kajiya"}[mode]
    state = pk._start_state(rays, integ)
    if bounce is not None and integ == "kajiya":
        st = torch.stack([*state[:15], state[15].to(torch.float32)])
        for b in range(nb):
            st = bounce(pix, st, frame, salt_base + 4 * b)
        rows = st.unbind(0)
        return pk._finish_plain("kajiya", style, (*rows[:15], rows[15] > 0.0),
                                None, None, None)
    final = torch.zeros_like(state[15])
    for b in range(nb):
        count("search", state[15])
        winner = search(state[:3], state[3:6], state[15])
        state, final = pk._shade_plain(integ, mat, pix, frame, salt_base + 4 * b,
                                       state, winner, final, search, count)
    return pk._finish_plain(integ, style, state, final if nb else None, search,
                            mat, count)
