"""Persistent plan store of the measured auto-tuner.

ftIMM's auto-tuning is a closed loop: the CMR model proposes, the card
disposes, and the winner is remembered so the search never reruns for a
shape the card has already answered.  This module is that memory: a JSON
file of measured winners keyed by

    (device kind, plan family, shape signature, dtype widths, variant)

that the planners (``tuner.plan_*``) consult before their CMR argmin.  A
record holds only the decision (body, tile, grid order, K slices, split
count, fusion) and its provenance (measured and analytic times, the timing
engine); the planner matches it against the candidates the call allows at
lookup, so a record can suggest a plan but never force one the kernels
cannot run.

The device kind is the timing device's name (``device_kind``): a file
measured on one card model is ignored wholesale on another, and on the CPU.
Missing, corrupt or wrong-schema files are ignored: ``load`` returns 0 and
never raises.  Records the port's kernels cannot run at all (an unknown
body, a tile the kernels are not compiled for, shared memory over a
block's budget, the TPU's padded-edge policy) are quarantined at load with
a reason code each and never served.

The file also carries the calibration fitted by ``autotune.calibrate``:
the achievable fractions of the card's peak rate and bandwidth, so that
shapes never measured plan against corrected constants too.  It applies
only when fitted against the port's ``HopperSpec`` (``base_spec``).

The process-global store is ``get_store()``; it loads ``$REPRO_PLAN_CACHE``
on first use.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

from ...kernels.ftimm.kernel import (BODIES, GROUP_TC_TILE, GSTREAM_ROWS,
                                     STREAM_ROWS, STREAM_SLICE_STEP,
                                     STREAM_SMEM, STREAM_STRIP, TC_STAGES,
                                     TC_TILES, fma_tiles, gstream_smem,
                                     smem_bytes)
from ...runtime.chaos import fire as _chaos_fire
from .cmr import H100

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_PLAN_CACHE"

# Fields a record may carry.  Only the tile ("bm", "bn", "bk") is
# mandatory; "body" defaults to "fma" and "kslices" to 1.
_RECORD_KEYS = frozenset({
    "bm", "bn", "bk", "nsplit", "dim_order", "strategy", "schedule", "edge",
    "fuse", "t_measured_us", "t_analytic_us", "t_model_us", "engine", "mode",
    "body", "kslices",
})


def device_kind(device: str | torch.device | None = None) -> str:
    """Canonical name of the timing device: the CUDA card's name, lowercased
    with "_" for spaces ("nvidia_h100_80gb_hbm3"), or "cpu".  With no
    ``device``, the current CUDA card when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device).strip().lower().replace(" ",
                                                                      "_")


def shape_key(family: str, dims: tuple, in_bytes: int, out_bytes: int,
              num_shards: int = 1, extra: str = "") -> str:
    """Canonical store key: family + shape signature + dtype widths +
    placement request.  ``dims`` is the family's positional shape tuple
    ((m,k,n) dense, (g,m,k,n) batched, (g,total,k,n) ragged); ``extra``
    carries family variants joined with "+" (``tuner.key_extra``)."""
    d = "x".join(str(int(x)) for x in dims)
    key = f"{family}|{d}|ib{int(in_bytes)}|ob{int(out_bytes)}"
    if extra:
        key += f"|{extra}"
    if num_shards > 1:
        key += f"|shards{int(num_shards)}"
    return key


@dataclass
class Calibration:
    """Fitted effective-hardware constants (fractions of the spec's peaks).
    ``ici_frac`` and ``flops_frac_int8`` are read and written for the
    reference's file format; the port fits neither yet."""
    flops_frac: float = 1.0     # achievable fraction of the peak FLOP/s
    bw_frac: float = 1.0        # achievable fraction of the HBM bandwidth
    ici_frac: float = 1.0
    flops_frac_int8: float | None = None
    n_samples: int = 0
    engine: str = ""
    base_spec: str = ""

    def to_json(self) -> dict:
        d = {"flops_frac": self.flops_frac, "bw_frac": self.bw_frac,
             "ici_frac": self.ici_frac, "n_samples": self.n_samples,
             "engine": self.engine, "base_spec": self.base_spec}
        if self.flops_frac_int8 is not None:
            d["flops_frac_int8"] = self.flops_frac_int8
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Calibration":
        int8 = d.get("flops_frac_int8")
        return cls(flops_frac=float(d["flops_frac"]),
                   bw_frac=float(d["bw_frac"]),
                   ici_frac=float(d.get("ici_frac", 1.0)),
                   flops_frac_int8=None if int8 is None else float(int8),
                   n_samples=int(d.get("n_samples", 0)),
                   engine=str(d.get("engine", "")),
                   base_spec=str(d.get("base_spec", "")))


@dataclass
class PlanStore:
    """In-memory view of one plan-store file.  ``quarantined`` maps the
    keys of records refused at load to their reason codes; those shapes
    plan analytically, and ``tuner.plan_mode_stats`` counts them."""
    kind: str = ""                          # device kind the entries measure
    entries: dict = field(default_factory=dict)
    calibration: Calibration | None = None
    path: str | None = None                 # last load / save path
    quarantined: dict = field(default_factory=dict)
    lookups: int = 0                        # telemetry: lookup() calls
    hits: int = 0                           # telemetry: lookups that served

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, key: str) -> dict | None:
        """Record for ``key`` if it was measured on the current device."""
        self.lookups += 1
        if not self.entries or self.kind != device_kind():
            return None
        rec = self.entries.get(key)
        if rec is not None:
            self.hits += 1
        return rec

    def put(self, key: str, record: dict, kind: str | None = None) -> None:
        """Store ``record`` under ``key``, measured on ``kind`` (default:
        the current device).  Records of two device kinds never mix."""
        kind = kind or device_kind()
        if self.kind and self.kind != kind:
            raise ValueError(f"the store holds {self.kind} records; a {kind} "
                             "record does not belong with them")
        self.kind = kind
        self.entries[key] = {k: v for k, v in record.items()
                             if k in _RECORD_KEYS}

    def clear(self) -> None:
        self.entries.clear()
        self.quarantined.clear()
        self.calibration = None
        self.kind = ""
        self.lookups = 0
        self.hits = 0

    # -- persistence ------------------------------------------------------

    def load(self, path: str) -> int:
        """Merge entries from ``path``.  Returns the number of entries
        adopted; 0 (never an exception) for missing / corrupt / wrong-schema
        / wrong-device files."""
        try:
            with open(path) as fp:
                blob = json.load(fp)
        except (OSError, ValueError):
            return 0
        if not isinstance(blob, dict) \
                or blob.get("schema") != SCHEMA_VERSION:
            return 0
        kind = blob.get("device_kind")
        if kind != device_kind():
            return 0        # measured elsewhere: times do not transfer
        entries = blob.get("entries")
        if not isinstance(entries, dict):
            return 0
        if self.kind != kind:
            self.entries.clear()    # another device's records: dropped
        self.kind = kind
        n = 0
        for key, rec in entries.items():
            if isinstance(rec, dict) and "bm" in rec:
                bad = record_violations(key, rec)
                if bad:
                    self.quarantined[key] = bad
                    continue
                self.put(key, rec, kind)
                n += 1
        cal = blob.get("calibration")
        if isinstance(cal, dict):
            try:
                self.calibration = Calibration.from_json(cal)
            except (KeyError, TypeError, ValueError):
                pass
        self.path = path
        return n

    def save(self, path: str | None = None) -> str:
        """Write the store to ``path`` (default: the last one), replacing
        the file atomically: a crashed writer never leaves a torn file."""
        path = path or self.path
        if path is None:
            raise ValueError("no path: pass one or load() first")
        blob = {
            "schema": SCHEMA_VERSION,
            "device_kind": self.kind or device_kind(),
            "entries": self.entries,
        }
        if self.calibration is not None:
            blob["calibration"] = self.calibration.to_json()
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".plan_cache.")
        try:
            with os.fdopen(fd, "w") as fp:
                json.dump(blob, fp, indent=1, sort_keys=True)
                fp.flush()
                os.fsync(fp.fileno())
            _chaos_fire("plan_save_crash")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.path = path
        return path


def _widths(key: str) -> tuple[int, int] | None:
    """(A's width, B's width) of a key: its ``ib`` field and its ``bb``
    fragment (B's width when it differs from A's); None if unparseable."""
    parts = key.split("|")
    try:
        ib = int(parts[2].removeprefix("ib"))
    except (IndexError, ValueError):
        return None
    bb = ib
    for frag in (parts[4].split("+") if len(parts) > 4 else ()):
        if frag.startswith("bb") and frag[2:].isdigit():
            bb = int(frag[2:])
    return ib, bb


def _variant(key: str) -> tuple[str, int, bool] | None:
    """(kernel, panels, group stream) of a key's family and fragments, or
    None for an unknown family: the kernel whose tile menu and ring depth
    the record must fit."""
    parts = key.split("|")
    if len(parts) < 4:
        return None
    frags = set(parts[4].split("+")) if len(parts) > 4 else set()
    panels = 2 if "pair" in frags else 1
    if parts[0] == "dense":
        kernel = "ftimm_gemm_swiglu" if panels == 2 else "ftimm_gemm"
        return kernel, panels, panels == 2
    if parts[0] == "batched":
        return "ftimm_gemm_grouped", panels, True
    if parts[0] == "ragged":
        if "ragged:k" in frags:
            return "ftimm_gemm_ragged_dw", 1, False
        return "ftimm_gemm_ragged", panels, True
    return None


def record_violations(key: str, rec: dict) -> list[str]:
    """Reason codes for a record the port's kernels cannot run: the
    load-time quarantine.  Empty for a runnable record."""
    variant = _variant(key)
    if variant is None:
        return ["malformed_key"]
    kernel, panels, group = variant
    try:
        bm, bn, bk = int(rec["bm"]), int(rec["bn"]), int(rec["bk"])
        body = str(rec.get("body", "fma"))
        nsplit = int(rec.get("nsplit", 1))
        kslices = int(rec.get("kslices", 1))
        order = str(rec.get("dim_order", "mn"))
    except (KeyError, TypeError, ValueError):
        return ["malformed_record"]
    bad = []
    if order not in ("mn", "nm") or nsplit < 1 or kslices < 1:
        bad.append("malformed_record")
    if rec.get("edge", "masked") != "masked":
        bad.append("edge_padded")       # every Hopper body masks its edges
    if body not in BODIES or (body == "stream"
                              and kernel == "ftimm_gemm_ragged_dw"):
        return bad + ["unknown_body"]
    if nsplit > 1 and (kernel != "ftimm_gemm" or body == "stream"):
        bad.append("nsplit_invalid")    # split-K: dense, fma or tc only
    widths = _widths(key)
    if widths is None:
        return bad + ["malformed_key"]
    if nsplit > 1 and (widths[0] != widths[1] or 1 in widths):
        # No split-K kernel takes a mixed or 1-byte pair (the reference's
        # conservative quarantine: no such variant is ever measured).
        bad.append("splitk_mixed_dtype")
    staged = 0              # the register stream's staged rows
    if body == "fma":
        ok = (bm, bn, bk) in fma_tiles(*widths)
        smem = smem_bytes(bm, bn, bk, panels)
    elif body == "tc":
        menu = TC_TILES if kernel in ("ftimm_gemm", "ftimm_gemm_ragged_dw") \
            else (GROUP_TC_TILE,)
        stages = TC_STAGES.get(kernel, TC_STAGES["ftimm_gemm"])
        ok = (bm, bn, bk) in menu
        smem = smem_bytes(bm, bn, bk, panels, body="tc", stages=stages)
    elif group:
        ok = bm == GSTREAM_ROWS and bn == STREAM_STRIP \
            and bk > 0 and bk % STREAM_SLICE_STEP == 0
        smem = gstream_smem(panels)
    else:
        ok = bm in STREAM_ROWS and bn == STREAM_STRIP \
            and bk > 0 and bk % STREAM_SLICE_STEP == 0
        smem, staged = smem_bytes(bm, bn, bk, body="stream"), bm * bk * 2
    if not ok:
        bad.append("tile_not_compiled")
    if smem > H100.smem_per_block or staged > STREAM_SMEM:
        bad.append("smem_over_budget")
    return bad


_STORE = PlanStore()
_env_checked = False


def get_store() -> PlanStore:
    """The process-global store; loads ``$REPRO_PLAN_CACHE`` on first use."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        path = os.environ.get(ENV_VAR)
        if path:
            _STORE.load(path)
    return _STORE


def reset_store() -> None:
    """Drop all in-memory entries and the calibration (the file is
    untouched).  The ``$REPRO_PLAN_CACHE`` auto-load is not re-armed: after
    a reset the store stays empty until an explicit ``load``."""
    global _env_checked
    _env_checked = True
    _STORE.clear()
    _STORE.path = None
