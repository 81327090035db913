"""What the window's timed path produces, kept for the comparison: each
served token with its host time, and the logits it was taken from.

``TimedList`` is a request's output list: the server appends each token as
it reads it back, and the list stamps it with the host clock and the index
of the decode step that produced it.  ``LogitKeeper`` keeps, for the
sampled requests only, the logits of each of their tokens: the admission
prefill's (the serving steps call ``apply_model`` with a ``logit_index``
for it) and each decode step's row of the request's slot (the server's
decode returns ``(state, logits, telemetry)``).  It wraps the server's own
``_admit_request`` and ``_decode`` on this server object and the steps
module's ``apply_model`` for the window only, and copies rows on the
device; it reads nothing back to the host inside the window.
"""
from __future__ import annotations

import contextlib
import time


class TimedList(list):
    """A request's output tokens with their host times and decode steps."""

    def __init__(self, keeper=None):
        super().__init__()
        self.times, self.steps = [], []
        self._keeper = keeper

    def append(self, tok):
        self.times.append(time.perf_counter())
        self.steps.append(self._keeper.step if self._keeper else None)
        super().append(tok)


class LogitKeeper:
    def __init__(self, rids):
        self.rids = set(rids)
        self.step = 0                  # decode steps run so far
        self.slot_rid = {}             # slot -> request admitted there
        self.prefill = {}              # rid -> logits of its first token
        self.decode = {}               # step -> ({rid: row}, rows tensor)
        self._rid = None

    @contextlib.contextmanager
    def installed(self, server):
        from repro_torch.serving import steps

        admit, decode, model = (server._admit_request, server._decode,
                                steps.apply_model)
        keeper = self

        def admit_named(state, req, slot):
            keeper._rid = req.rid
            keeper.slot_rid[slot] = req.rid
            try:
                return admit(state, req, slot)
            finally:
                keeper._rid = None

        def model_kept(*a, **kw):
            out = model(*a, **kw)
            if (kw.get("logit_index") is not None
                    and keeper._rid in keeper.rids):
                keeper.prefill[keeper._rid] = out[0][0, -1].detach().clone()
            return out

        class DecodeKept:
            """The server's decode, keeping the sampled slots' rows."""

            def __call__(self, *a, **kw):
                state, logits, tel = decode(*a, **kw)
                keeper.step += 1
                rows = {rid: slot for slot, rid in keeper.slot_rid.items()
                        if rid in keeper.rids}
                if rows:
                    slots = sorted(rows.values())
                    pick = logits[slots, -1].detach().clone()
                    keeper.decode[keeper.step] = (
                        {rid: slots.index(s) for rid, s in rows.items()},
                        pick)
                return state, logits, tel

            def __getattr__(self, name):
                return getattr(decode, name)

        server._admit_request, server._decode = admit_named, DecodeKept()
        steps.apply_model = model_kept
        try:
            yield self
        finally:
            steps.apply_model = model
            server._admit_request, server._decode = admit, decode

    def logits_of(self, rid, out: TimedList) -> list:
        """The kept logits of each token of request ``rid`` (None where
        none was kept)."""
        res = [self.prefill.get(rid)]
        for s in out.steps[1:]:
            entry = self.decode.get(s)
            res.append(entry[1][entry[0][rid]]
                       if entry is not None and rid in entry[0] else None)
        return res
