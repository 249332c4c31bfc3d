"""A group of torch devices that step one mesh together: the counterpart
of the ``jax.sharding.Mesh`` of dynearthsol_tpu/parallel/ and of the
collectives its shard_map steps call (``ppermute``, ``pmin``, ``pmax``,
``psum``).

One process, one Python thread per shard.  ``ShardGroup.run(fn)`` calls
``fn(d)`` for every shard d in a thread of its own, on its device (an
entry may repeat: N shards may share one card or the CPU) and, on the
card, on a CUDA stream of its own.  The shards meet only in the
collectives below, which wait at one ``threading.Barrier``:

* ``exchange(d, buf, rows)``: ``halo_overlap_add`` of the JAX package's
  ops/assembly.py.  Shard d adds its left neighbour's last ``rows`` rows
  to its first ``rows`` rows and its right neighbour's first rows to its
  last; the edge shards add nothing.  Each overlap row is then
  ``own + neighbour``, a two-term IEEE add, the same bits on both owners.
* ``pmin``, ``pmax`` and ``pminmax`` (both in one meeting), elementwise
  over tensors of any shape: exact on every shard.
* ``psum``, the shards' values added in shard order, ((x0 + x1) + x2) ...,
  on every shard: every shard gets the same bits, with no atomics.

A shard offers its tensor with an event recorded on its stream; a reader
makes its own stream wait on that event and marks the tensor as used by
that stream (``record_stream``), so the caching allocator keeps its
memory until the reader's work is done.  A tensor on another card is
copied with ``Tensor.to`` (peer to peer where the cards allow it).  Every
offer carries a tag (the collective and its arguments); shards that meet
at different collectives raise instead of mixing their data.  If any
shard raises, the barrier is aborted, every other shard leaves its wait,
and ``run`` re-raises the first shard's exception in the caller: a failed
shard ends the run and never hangs it.

``torch.distributed`` is not used: NCCL refuses two ranks on one card,
gloo moves no CUDA tensors, and a group of processes could never hold
more than one shard on a machine with one card.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

# seconds a shard waits at a collective before the run is called hung
BARRIER_TIMEOUT_S = 600.0


class ShardsOutOfStep(RuntimeError):
    """The shards met at different collectives."""


class ShardGroup:
    """The shards of one run: ``devices[d]`` holds shard d.  ``stats``
    counts the collectives each shard took part in and the host seconds
    it spent in them (from its offer to its result)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        for dev in self.devices:
            if dev.type == "cuda" and dev.index is None:
                raise ValueError("name each card with its index "
                                 "(cuda:0, cuda:1, ...)")
        self.n = len(self.devices)
        self._barrier = threading.Barrier(self.n, timeout=BARRIER_TIMEOUT_S)
        # two slot arrays used in turn: a shard can only overwrite a slot
        # array after every shard has passed the meeting that follows the
        # one that read it
        self._slots = ([None] * self.n, [None] * self.n)
        self._round = [0] * self.n
        self._streams = [torch.cuda.Stream(device=dev)
                         if dev.type == "cuda" else None
                         for dev in self.devices]
        self.stats = [{"collectives": 0, "host_s": 0.0}
                      for _ in range(self.n)]

    def axis(self, d: int) -> "ShardAxis":
        """Shard d's handle on the group: what the step calls."""
        return ShardAxis(self, d)

    def reset_stats(self):
        for st in self.stats:
            st.update(collectives=0, host_s=0.0)

    # ---------------------------------------------------------- running

    def run(self, fn):
        """[fn(0), ..., fn(n - 1)], each in a thread of its own on its
        device and stream.  The caller's stream on each card waits for
        the shards' work before this returns."""
        self._barrier.reset()
        self._slots = ([None] * self.n, [None] * self.n)
        self._round = [0] * self.n
        results = [None] * self.n
        errors = [None] * self.n
        done = [None] * self.n

        def work(d):
            try:
                dev = self.devices[d]
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                    with torch.cuda.stream(self._streams[d]):
                        results[d] = fn(d)
                        self._meet(d, ("end",), None)
                        done[d] = torch.cuda.Event()
                        done[d].record(self._streams[d])
                else:
                    results[d] = fn(d)
                    self._meet(d, ("end",), None)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[d] = e
                self._barrier.abort()

        threads = [threading.Thread(target=work, args=(d,),
                                    name=f"shard-{d}", daemon=True)
                   for d in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     None) or next((e for e in errors if e is not None),
                                   None)
        if first is not None:
            raise first
        for d, ev in enumerate(done):
            if ev is not None:
                torch.cuda.current_stream(self.devices[d]).wait_event(ev)
        return results

    # ------------------------------------------------------ the meeting

    def _meet(self, d: int, tag, payload):
        """Offer ``payload`` (a tensor, a tuple of tensors or None) under
        ``tag``; return every shard's payload, in shard order, once all
        have offered."""
        t0 = time.perf_counter()
        if isinstance(payload, torch.Tensor):
            payload = (payload,)
        ev = None
        dev = self.devices[d]
        if dev.type == "cuda" and payload is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        slots = self._slots[self._round[d] & 1]
        self._round[d] += 1
        slots[d] = (tag, payload, ev)
        self._barrier.wait()
        got = list(slots)
        for i, (t, _, _) in enumerate(got):
            if t != tag:
                raise ShardsOutOfStep(
                    f"shard {d} met shard {i} at {tag}, which is at {t}")
        st = self.stats[d]
        st["collectives"] += 1
        st["host_s"] += time.perf_counter() - t0
        return got

    def _fetch(self, d: int, item, j: int = 0) -> torch.Tensor:
        """Tensor j of an offer, usable on shard d's device and stream."""
        _, payload, ev = item
        x = payload[j]
        dev = self.devices[d]
        if ev is None:
            return x if x.device == dev else x.to(dev)
        if x.device == dev:
            s = torch.cuda.current_stream(dev)
            s.wait_event(ev)
            x.record_stream(s)
            return x
        # another card: the copy runs on the source card's current stream
        # of this thread, which first waits for the producer
        src = torch.cuda.current_stream(x.device)
        src.wait_event(ev)
        x.record_stream(src)
        return x.to(dev)

    # ------------------------------------------------------ collectives

    def exchange(self, d: int, buf: torch.Tensor, rows: int):
        """buf (W, ...) with the neighbours' overlap rows added: its first
        ``rows`` rows plus shard d-1's last ``rows``, its last ``rows``
        plus shard d+1's first ``rows``."""
        w = buf.shape[0]
        if not 0 < rows <= w // 2:
            raise ValueError(f"{rows} overlap rows in a window of {w}")
        head, tail = buf[:rows], buf[w - rows:]
        got = self._meet(d, ("exchange", rows, tuple(buf.shape[1:]),
                             buf.dtype), (head, tail))
        if d > 0:
            head = head + self._fetch(d, got[d - 1], 1)
        if d < self.n - 1:
            tail = tail + self._fetch(d, got[d + 1], 0)
        return torch.cat([head, buf[rows:w - rows], tail])

    def _gather(self, d, tag, x):
        got = self._meet(d, tag, x)
        return [self._fetch(d, g) for g in got]

    def pmin(self, d: int, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._gather(d, ("pmin", tuple(x.shape)),
                                        x)).amin(0)

    def pmax(self, d: int, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._gather(d, ("pmax", tuple(x.shape)),
                                        x)).amax(0)

    def pminmax(self, d: int, lo: torch.Tensor, hi: torch.Tensor):
        """(pmin(lo), pmax(hi)) in one meeting."""
        got = self._meet(d, ("pminmax", tuple(lo.shape), tuple(hi.shape)),
                         (lo, hi))
        los = torch.stack([self._fetch(d, g, 0) for g in got]).amin(0)
        his = torch.stack([self._fetch(d, g, 1) for g in got]).amax(0)
        return los, his

    def psum(self, d: int, x: torch.Tensor) -> torch.Tensor:
        """The shards' x added in shard order: the same bits on every
        shard."""
        parts = self._gather(d, ("psum", tuple(x.shape), x.dtype), x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def host_ms_per_collective(self) -> float:
        """Mean host ms a shard spent in one collective, since the last
        ``reset_stats``."""
        n = sum(st["collectives"] for st in self.stats)
        return (1e3 * sum(st["host_s"] for st in self.stats) / n) if n \
            else 0.0


@dataclass(frozen=True)
class ShardAxis:
    """Shard ``index``'s handle on its group, in the step's context
    (``StepCtx.axis``): the counterpart of the shard_map axis name the JAX
    package's step passes to its collectives."""

    group: ShardGroup
    index: int

    def exchange(self, buf, rows: int):
        return self.group.exchange(self.index, buf, rows)

    def pmin(self, x):
        return self.group.pmin(self.index, x)

    def pmax(self, x):
        return self.group.pmax(self.index, x)

    def pminmax(self, lo, hi):
        return self.group.pminmax(self.index, lo, hi)

    def psum(self, x):
        return self.group.psum(self.index, x)
