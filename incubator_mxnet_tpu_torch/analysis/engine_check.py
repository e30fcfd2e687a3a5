"""Strict-mode hazard checks of bulk segments (``GRAFT_ENGINE_CHECK=1``).

Counterpart of ``incubator_mxnet_tpu/analysis/engine_check.py``.  A bulk
segment (``engine.py``) is a small dataflow program over arrays that can
be rebound while it records: a view of a deferred array records a
``_bulk_view_extract`` node, a write through such a view records a
``_bulk_view_write`` node that rebinds the base.  The engine guards these
with version counters; strict mode verifies the guards:

=======  ==============================================================
EH101    stale-extract read (write-after-read): an instruction consumes,
         through the view that extracted it, a ``_bulk_view_extract``
         value whose base was rebound after the extract was recorded
EH102    double-write rebind (lost update): a ``_bulk_view_write`` whose
         base operand is no longer the base's current binding
EH103    segment integrity: an operand that resolves outside the
         segment's external inputs (an out-of-range slot, a value read
         before it is produced) or an external input no instruction reads
EH104    fused/unfused divergence: the segment's replay (a captured CUDA
         graph on the card) and a second run of the same program op by op
         disagree in any bit of a live output
=======  ==============================================================

The port compares EH104 bit for bit: a graph replays the very kernels
the op-by-op run launches, so there is no fusion to re-round (the JAX
build allows a few ulps for XLA's fusion).
"""
from __future__ import annotations

import torch

__all__ = ["EngineHazardError", "check_segment_integrity", "oracle_compare",
           "HAZARDS"]

HAZARDS = {
    "EH101": "stale-extract read (write-after-read hazard)",
    "EH102": "double-write rebind (lost-update hazard)",
    "EH103": "segment integrity violation / escaped external",
    "EH104": "fused/unfused replay divergence (fusion-equivalence oracle)",
}


class EngineHazardError(RuntimeError):
    """A hazard: ``code`` is one of :data:`HAZARDS`, ``detail`` holds the
    hazard's particulars."""

    def __init__(self, code, message, **detail):
        super().__init__("%s [%s]: %s" % (code, HAZARDS.get(code, "?"),
                                          message))
        self.code = code
        self.detail = detail


def check_segment_integrity(instrs, n_ext, n_rng=0):
    """EH103 over a segment's instructions ``(op_name, kw, key, is_train,
    in_refs, rng_slot, n_out, rec)``: ``("e", i)`` operands must name one
    of the ``n_ext`` external inputs, ``("t", i)`` operands a value an
    earlier instruction produced, ``rng_slot`` one of the ``n_rng``
    generators; every external input must be read."""
    produced = 0
    used_ext = set()
    for k, (name, _kw, _key, _train, in_refs, rng_slot, n_out, _rec) in \
            enumerate(instrs):
        for tag, i in in_refs:
            if tag == "e":
                if not 0 <= i < n_ext:
                    raise EngineHazardError(
                        "EH103", "instruction #%d (%s) reads external slot %d "
                        "but the segment holds %d external input(s)"
                        % (k, name, i, n_ext), instruction=k, op=name, slot=i)
                used_ext.add(i)
            elif not 0 <= i < produced:
                raise EngineHazardError(
                    "EH103", "instruction #%d (%s) reads value %d before it "
                    "is produced (%d exist at that point)"
                    % (k, name, i, produced), instruction=k, op=name, slot=i)
        if rng_slot is not None and not 0 <= rng_slot < n_rng:
            raise EngineHazardError(
                "EH103", "instruction #%d (%s) draws from generator slot %d "
                "of %d" % (k, name, rng_slot, n_rng), instruction=k, op=name,
                slot=rng_slot)
        produced += n_out
    orphans = sorted(set(range(n_ext)) - used_ext)
    if orphans:
        raise EngineHazardError(
            "EH103", "external slot(s) %s are read by no instruction: an "
            "orphan input pollutes the program key and pins a dead buffer"
            % (orphans,), orphans=orphans)


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    """The tensor's bit pattern as integers (float NaN payloads included)."""
    t = t.detach().contiguous()
    if t.dtype.is_floating_point and t.element_size() in _INT_VIEW:
        return t.view(_INT_VIEW[t.element_size()])
    return t


def oracle_compare(fused, unfused, instrs, live):
    """EH104: every live output of the replay (``fused``) must equal, bit
    for bit, the same output of the op-by-op run (``unfused``)."""
    for pos, (f, u) in enumerate(zip(fused, unfused)):
        if f.dtype == u.dtype and f.shape == u.shape \
                and torch.equal(_bits(f), _bits(u)):
            continue
        raise EngineHazardError(
            "EH104", "the replay and the op-by-op run disagree on live "
            "output #%d (shape %s/%s, dtype %s/%s) of segment %s"
            % (pos, tuple(f.shape), tuple(u.shape), f.dtype, u.dtype,
               [i[0] for i in instrs]),
            output=pos, live=list(live), ops=[i[0] for i in instrs])
