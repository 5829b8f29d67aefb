"""Collective-volume accounting for the sharded SPMD pipeline.

Every collective in parallel/sharded.py runs inside shard_map'd kernels
whose shapes are static per chunk, so the bytes each device moves are
known at trace time.  The ledger records, per pipeline phase, the payload
bytes of each collective per kernel invocation (captured once, when the
kernel traces) and the number of invocations; `report()` folds both into
total logical payload and per-device wire bytes:

    all_gather over axis size A : each device receives (A-1)/A of the
                                  gathered buffer  -> wire = out*(A-1)/A
    all_to_all  over axis size A: (A-1)/A of the buffer changes device
    ppermute                    : the whole buffer crosses one link
    psum (ring allreduce)       : 2*(A-1)/A of the buffer

The report holds counters only (no timers): collective time is read from
a device trace, not modelled here."""

import contextlib
from collections import defaultdict


class CollectiveLedger:
    def __init__(self):
        self.reset()

    def reset(self):
        # (phase, op, axis, axis_size) -> accumulated payload bytes across
        # all invocations (each invocation charged its LIVE trace variant's
        # bytes, so retraces with different static shapes are exact —
        # ADVICE r4: the old per_call x total-calls fold over-counted when
        # a phase's kernel retraced mid-run)
        self.totals = defaultdict(int)
        self.calls = defaultdict(int)          # phase -> invocation count
        self._variant = {}    # phase -> {(op, axis, asize): bytes/call}
        self._last_per_call = {}
        self._phase = None
        self._events = None

    @contextlib.contextmanager
    def phase(self, name):
        """Wrap ONE kernel invocation.  record() calls during the body
        (they only fire when jit actually traces) define the phase's new
        static-shape variant; on exit the invocation is charged the live
        variant's bytes."""
        prev, prev_ev = self._phase, self._events
        self._phase, self._events = name, []
        try:
            yield
        finally:
            if self._events:       # kernel (re)traced: new shape variant
                var = defaultdict(int)
                for op, axis, asize, nbytes in self._events:
                    var[(op, axis, asize)] += nbytes
                self._variant[name] = dict(var)
            for key, nbytes in self._variant.get(name, {}).items():
                self.totals[(name,) + key] += nbytes
                self._last_per_call[(name,) + key] = nbytes
            self.calls[name] += 1
            self._phase, self._events = prev, prev_ev

    def invoke(self, name):
        """Kept for call-site clarity; the invocation accounting happens in
        phase()'s exit (one phase() enter == one kernel invocation)."""

    def record(self, op, axis, axis_size, *arrays):
        """Called at TRACE time inside a kernel: log the payload bytes of
        `arrays` for the current invocation's (re)trace."""
        if self._events is None:
            return
        nbytes = 0
        for a in arrays:
            n = 1
            for d in a.shape:
                n *= int(d)
            nbytes += n * a.dtype.itemsize
        self._events.append((op, axis, axis_size, nbytes))

    # ----------------------------------------------------------- reporting

    _WIRE = {
        "all_gather": lambda b, a: b * (a - 1),         # out buffer = a*b
        "all_to_all": lambda b, a: b * (a - 1) / a,
        "ppermute": lambda b, a: b,
        "psum": lambda b, a: 2 * b * (a - 1) / a,
    }

    def report(self):
        """Per-phase collective payload and wire-byte totals."""
        phases = {}
        for (phase, op, axis, asize), total in sorted(self.totals.items()):
            calls = self.calls.get(phase, 1)
            wire = self._WIRE[op](total, max(asize, 1))
            rec = phases.setdefault(phase, {
                "invocations": calls, "collectives": [],
                "payload_bytes": 0, "wire_bytes": 0})
            rec["collectives"].append({
                "op": op, "axis": axis, "axis_size": asize,
                "payload_bytes_per_call": self._last_per_call.get(
                    (phase, op, axis, asize), 0),
                "payload_bytes": total, "wire_bytes": int(wire)})
            rec["payload_bytes"] += total
            rec["wire_bytes"] += int(wire)
        return {
            "phases": phases,
            "total_payload_bytes": sum(p["payload_bytes"]
                                       for p in phases.values()),
            "total_wire_bytes": sum(p["wire_bytes"]
                                    for p in phases.values()),
        }


LEDGER = CollectiveLedger()
