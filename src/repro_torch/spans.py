"""Host spans of the serving path: where the host is, on
``time.time_ns()``'s clock (the clock kineto stamps the card's events on),
so that a device trace's idle gaps can be filed under the layer and the
sync that left the card waiting.

The recorder is off by default.  ``start()`` turns it on and ``stop()``
turns it off and hands out the records, each a tuple

  ``(start_ns, end_ns, name, parent, attrs)``

in the order the spans opened: ``parent`` is the index of the enclosing
span's record (-1 at the top) and ``attrs`` a dict of host scalars and
strings known at the site (a request's ``rid``, a decode step's ``step``,
an MoE span's ``layer`` and ``phase``).  There is no exporter.

``span(name, **attrs)`` is a context manager, and, given the name alone,
a decorator.  Off, a site costs the check of the module flag and returns a
span object made once per name: it records nothing and builds nothing.
On, a span reads no tensor and never waits on the card; an attribute that
is not a host scalar or a string (a tensor) raises ``TypeError``.

The store's host seams (``models/moe.py::callback_seam``) are spanned by a
seam listener the recorder adds while it is on, as ``store.<seam>``.
Spans are kept for the thread that serves (the port's serving path has one).
"""
from __future__ import annotations

import functools
import time

import numpy as np

_on = False
_records: list = []      # [start_ns, end_ns, name, parent, attrs]
_open: list = []         # indices of the open records, innermost last
_sites: dict = {}        # name -> its span object while the recorder is off
_SCALARS = (bool, int, float, str, type(None), np.integer, np.floating)


def _enter(name: str, attrs) -> None:
    for k, v in attrs.items():
        if not isinstance(v, _SCALARS):
            raise TypeError(f"span {name!r}: attribute {k}={type(v).__name__}"
                            " is not a host scalar or string (a span never "
                            "reads the card)")
    _open.append(len(_records))
    _records.append([time.time_ns(), None, name,
                     _open[-2] if len(_open) > 1 else -1, attrs])


def _exit() -> None:
    if _open:            # a span opened before start() closes unrecorded
        _records[_open.pop()][1] = time.time_ns()


class _Span:
    """One span site: entered while the recorder is on, it records."""
    __slots__ = ("name", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        if _on:
            _enter(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if _on:
            _exit()
        return False

    def __call__(self, fn):
        """As a decorator: each call of ``fn`` is one span."""
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            _enter(name, attrs)
            try:
                return fn(*args, **kwargs)
            finally:
                _exit()
        return spanned


def span(name: str, **attrs):
    """A span named ``name`` (a context manager; with the name alone also a
    decorator), with ``attrs`` recorded beside it while the recorder is
    on."""
    if _on:
        return _Span(name, attrs)
    site = _sites.get(name)
    if site is None:
        site = _sites[name] = _Span(name, {})
    return site


class _SeamSpans:
    """The seam listener (``models/moe.py::add_seam_listener``): each entry
    of a store seam is a span ``store.<seam>`` with its MoE ``layer``."""

    def enter(self, seam, args):
        lid = args[1] if len(args) > 1 else None
        _enter("store." + seam.name,
               {"layer": lid} if isinstance(lid, (int, np.integer)) else {})

    def exit(self, seam):
        _exit()


_SEAMS = _SeamSpans()


def start() -> None:
    """Drop any earlier records and turn the recorder on."""
    global _on
    from repro_torch.models.moe import add_seam_listener
    stop()
    add_seam_listener(_SEAMS)
    _on = True


def stop() -> list:
    """Turn the recorder off; returns its records (spans still open get the
    stop time as their end)."""
    global _on
    from repro_torch.models.moe import remove_seam_listener
    if not _on:
        return []
    _on = False
    remove_seam_listener(_SEAMS)
    now = time.time_ns()
    out = [(r[0], now if r[1] is None else r[1], r[2], r[3], r[4])
           for r in _records]
    _records.clear()
    _open.clear()
    return out
