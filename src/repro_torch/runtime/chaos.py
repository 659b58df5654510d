"""Deterministic fault injection for chaos-testing the degradation paths.

Production serving meets shard loss, straggler collectives, corrupt plan
caches, kernel-launch failures and non-finite numerics as a matter of
routine.  This module makes every one of those failure modes a *seeded,
replayable event* so the graceful-degradation machinery (the dispatch
fallback ladder, the elastic re-planning supervisor, the serve engine's
containment guards) can be exercised in CI instead of discovered in an
incident.

A ``FaultPlan`` is a list of ``Fault`` specs, each naming an injection
*site* and which occurrences of that site should fail.  Sites are armed by
probe calls the production code already makes (``fire``/``should_fire``) —
when no plan is active the probe is one attribute read, so the hot paths
pay nothing.

Sites (the port wires all but ``burst_arrival``, which belongs to the
serve benchmark, not ported yet; ``parse_env`` accepts them all, as the
reference's does):

    kernel          any planned ftIMM kernel launch (the port raises:
                    kernel or raise, there is no plain-version rung)
    kernel_fused    only the fused-epilogue kernel and the one-launch
                    SwiGLU pairs (fused -> unfused rung)
    ep_ring         the EP ring-schedule executor (ring -> gather rung;
                    the ranks agree before any takes it)
    ep_gather       the EP gather exchange (gather -> single rung: the
                    panels gathered, the ragged kernels on all of them)
    shard_loss      a training step boundary (raises ``HostFailure``;
                    payload ``chips`` = lost chip count)
    nan_logits      serve decode output (poisons one slot's logits row;
                    payload ``slot``)
    transient_decode  serve decode call (raises ``TransientFault`` — the
                    retry/backoff path)
    slow_step       a sleep at the armed site (straggler simulation;
                    payload ``delay_s``)
    plan_save_crash plan-store ``save`` between temp-write and rename
                    (the crash-mid-save atomicity test)
    page_exhaustion serve KV page allocation (forces the allocator to
                    report exhaustion -> the preempt/re-prefill path even
                    when free pages remain)
    bucket_miss     serve prefill bucket lookup (forces a miss -> the
                    legacy exact-length prefill fallback rung)
    burst_arrival   the serve benchmark's arrival process (payload
                    ``burst`` = extra arrivals injected at once)

Activation: ``chaos(plan)`` context manager, or the ``REPRO_CHAOS`` env
var (``site@occurrence[xcount][:key=value,...]`` specs joined by ``;``,
e.g. ``REPRO_CHAOS="kernel@0;shard_loss@3:chips=4"``) for subprocess /
CI legs.  Injection happens at probe time, which is call time in the
eager port, so a given program replays identically under the same plan:
the point.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

ENV_VAR = "REPRO_CHAOS"

# Every probe site wired in the repo (the docstring above documents each).
# ``parse_env`` validates against this set so a typo'd CI spec fails loudly
# at startup instead of silently arming nothing.  Programmatic ``Fault``
# construction is NOT gated on it (tests invent sites freely).
KNOWN_SITES = frozenset({
    "kernel", "kernel_fused", "ep_ring", "ep_gather", "shard_loss",
    "nan_logits", "transient_decode", "slow_step", "plan_save_crash",
    "page_exhaustion", "bucket_miss", "burst_arrival",
})


class ChaosError(RuntimeError):
    """Base class for injected faults (tells handlers the failure is
    synthetic; real exceptions take the same degradation paths)."""


class KernelLaunchFailure(ChaosError):
    """Injected at the ``kernel``/``kernel_fused`` sites."""


class CollectiveFailure(ChaosError):
    """Injected at the ``ep_ring``/``ep_gather`` sites."""


class TransientFault(ChaosError):
    """A retryable fault (serve decode): succeeds on retry by construction
    because occurrences are count-based."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """Fail occurrences ``[at, at + count)`` of ``site``."""
    site: str
    at: int = 0
    count: int = 1
    chips: int = 1          # shard_loss payload: lost chip count
    slot: int = 0           # nan_logits payload: which serve slot
    delay_s: float = 0.0    # slow_step payload
    burst: int = 1          # burst_arrival payload: extra arrivals at once


class FaultPlan:
    """Seeded, replayable schedule of injected faults.

    ``seed`` keys nothing random inside the plan itself (occurrence
    selection is explicit) but is carried so helpers like ``corrupt_json``
    derive their deterministic corruption from the plan, and so two runs
    labelled with the same seed are bit-identical chaos."""

    def __init__(self, faults: list[Fault] | tuple = (), *, seed: int = 0):
        self.faults = list(faults)
        self.seed = seed
        self.counters: dict[str, int] = {}   # site -> occurrences armed
        self.fired: dict[str, int] = {}      # site -> faults injected

    def should_fire(self, site: str) -> Fault | None:
        """Arm one occurrence of ``site``; the matching Fault when this
        occurrence is scheduled to fail, else None."""
        n = self.counters.get(site, 0)
        self.counters[site] = n + 1
        for f in self.faults:
            if f.site == site and f.at <= n < f.at + f.count:
                self.fired[site] = self.fired.get(site, 0) + 1
                return f
        return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan(seed={self.seed}, faults={self.faults})"


_PAYLOAD_KEYS = frozenset({"chips", "slot", "delay_s", "burst"})


def _bad_segment(segment: str, why: str) -> ValueError:
    return ValueError(
        f"malformed {ENV_VAR} segment {segment!r}: {why} "
        f"(expected site@occurrence[xcount][:key=value,...])")


def parse_env(spec: str) -> FaultPlan:
    """``site@occurrence[xcount][:k=v,...]`` specs joined by ``;``.
    A bare ``seed=N`` entry sets the plan seed.

    Malformed specs raise ``ValueError`` naming the offending segment — a
    typo'd CI chaos leg must fail at startup, not silently arm nothing:
    unknown site names, non-integer occurrences/counts, unknown payload
    keys, and empty segments (a trailing/doubled ``;``) are all rejected.
    """
    faults: list[Fault] = []
    seed = 0
    if not spec.strip():
        return FaultPlan(faults, seed=seed)
    segments = [p.strip() for p in spec.split(";")]
    for i, raw in enumerate(segments):
        if not raw:
            if i == len(segments) - 1:
                raise _bad_segment(spec, "trailing ';' leaves an empty "
                                         "segment")
            raise _bad_segment(spec, f"empty segment at position {i}")
        if raw.startswith("seed="):
            try:
                seed = int(raw[5:])
            except ValueError:
                raise _bad_segment(raw, "seed must be an integer") from None
            continue
        part = raw
        payload: dict = {}
        if ":" in part:
            part, kv = part.split(":", 1)
            for item in filter(None, kv.split(",")):
                if "=" not in item:
                    raise _bad_segment(raw, f"payload {item!r} is not "
                                            "key=value")
                k, v = item.split("=", 1)
                if k not in _PAYLOAD_KEYS:
                    raise _bad_segment(
                        raw, f"unknown payload key {k!r} "
                             f"(known: {', '.join(sorted(_PAYLOAD_KEYS))})")
                try:
                    payload[k] = float(v) if k == "delay_s" else int(v)
                except ValueError:
                    raise _bad_segment(raw, f"payload {k}={v!r} is not "
                                            "numeric") from None
        at, count = 0, 1
        if "@" in part:
            part, occ = part.split("@", 1)
            occ_raw, cnt = occ, None
            if "x" in occ:
                occ, cnt = occ.split("x", 1)
            try:
                at = int(occ)
            except ValueError:
                raise _bad_segment(raw, f"occurrence {occ_raw!r} is not an "
                                        "integer") from None
            if cnt is not None:
                try:
                    count = int(cnt)
                except ValueError:
                    raise _bad_segment(raw, f"count {cnt!r} is not an "
                                            "integer") from None
        if part not in KNOWN_SITES:
            raise _bad_segment(raw, f"unknown site {part!r} "
                                    f"(known: {', '.join(sorted(KNOWN_SITES))})")
        faults.append(Fault(site=part, at=at, count=count, **payload))
    return FaultPlan(faults, seed=seed)


# Process-global active plan: None (the fast path) until the env var or the
# context manager installs one.
_ACTIVE: FaultPlan | None = None
_env_checked = False


def active() -> FaultPlan | None:
    """The installed plan, arming ``REPRO_CHAOS`` on first use."""
    global _ACTIVE, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            _ACTIVE = parse_env(spec)
    return _ACTIVE


@contextlib.contextmanager
def chaos(plan: FaultPlan | None):
    """Install ``plan`` as the active fault schedule for the block."""
    global _ACTIVE, _env_checked
    old, old_checked = _ACTIVE, _env_checked
    _ACTIVE, _env_checked = plan, True
    try:
        yield plan
    finally:
        _ACTIVE, _env_checked = old, old_checked


def should_fire(site: str) -> Fault | None:
    """Probe one occurrence of ``site`` (no-op without an active plan)."""
    plan = active()
    return plan.should_fire(site) if plan is not None else None


def fire(site: str) -> None:
    """Probe ``site`` and raise its fault class when armed."""
    f = should_fire(site)
    if f is None:
        return
    if site in ("kernel", "kernel_fused"):
        raise KernelLaunchFailure(f"injected {site} failure")
    if site in ("ep_ring", "ep_gather"):
        raise CollectiveFailure(f"injected {site} failure")
    if site == "transient_decode":
        raise TransientFault("injected transient decode fault")
    if site == "shard_loss":
        # Local import: runtime.fault_tolerance is a sibling module.
        from .fault_tolerance import HostFailure
        raise HostFailure(f.chips, "injected shard loss")
    if site == "plan_save_crash":
        raise ChaosError("injected crash between temp write and rename")
    raise ChaosError(f"injected {site} fault")


def maybe_delay(site: str = "slow_step") -> float:
    """Sleep the armed fault's ``delay_s`` (straggler simulation); returns
    the delay actually injected (0.0 when the site didn't fire)."""
    f = should_fire(site)
    if f is None or f.delay_s <= 0:
        return 0.0
    time.sleep(f.delay_s)
    return f.delay_s


def poison_logits(logits, site: str = "nan_logits"):
    """NaN-poison one slot's row of a logits tensor when the site fires
    (simulates a kernel emitting non-finite values).  Returns the (possibly
    copied) tensor, on its own device -- callers feed it to their
    non-finite guard.  With no plan active the tensor comes back as it
    is, with no copy."""
    f = should_fire(site)
    if f is None:
        return logits
    out = logits.clone()
    out[min(f.slot, out.shape[0] - 1)] = float("nan")
    return out


def corrupt_json(path: str, *, seed: int | None = None,
                 mode: str = "truncate") -> None:
    """Deterministically corrupt a JSON file in place — the
    corrupted/truncated plan-cache-record fault.  ``truncate`` cuts the
    file mid-record at a seed-derived offset; ``scramble`` flips bytes at
    seed-derived positions (valid-length, invalid-content)."""
    plan = active()
    if seed is None:
        seed = plan.seed if plan is not None else 0
    with open(path, "rb") as fp:
        raw = bytearray(fp.read())
    if len(raw) < 4:
        raw = bytearray(b"{" * 4)
    if mode == "truncate":
        cut = 1 + (seed * 2654435761 % max(len(raw) - 2, 1))
        raw = raw[:cut]
    elif mode == "scramble":
        for i in range(8):
            pos = (seed * 2654435761 + i * 40503) % len(raw)
            raw[pos] = (raw[pos] + 13) % 256
    else:
        raise ValueError(f"unknown corruption mode: {mode!r}")
    with open(path, "wb") as fp:
        fp.write(bytes(raw))
