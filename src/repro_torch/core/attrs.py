"""Unified attribute system — layered, queryable fine-tuning controls.

The paper's abstract promises "flexible controls for incrementally
fine-tuning communication resources and runtime behavior"; in LCI that is
a uniform *attribute* mechanism: every resource is allocated with
named-argument overrides layered over environment and global defaults, and
every attribute is queryable at runtime (``get_attr_*``).  This module is
that mechanism for LCI-X:

* a **typed registry** (:data:`REGISTRY`) lists every tunable once — name,
  type, default, validation bounds, mutability, and which resource kinds
  expose it (``registry_table()`` renders the DESIGN.md §12 table);
* a **four-layer resolution chain** (:func:`resolve`), lowest to highest
  precedence::

      library defaults  →  REPRO_ATTR_* environment overrides
                        →  runtime-level config (LocalCluster(attrs=...),
                           explicit CommConfig fields)
                        →  per-resource named-argument overrides at alloc

  Every layer is validated with errors that *name the attribute*
  (:class:`AttrError`, both a ``ValueError`` and a ``FatalError``), so a
  bad knob fails at allocation time, not deep in a progress pass;
* an **introspection mixin** (:class:`AttrResource`) giving every resource
  object ``get_attr(name)`` / ``.attrs`` over both its resolved tunables
  and read-only *discovered* attributes (effective widths, contention
  telemetry) registered per instance with :meth:`AttrResource._export_attr`.

Mutability classes:

* ``alloc``    — settable through the full four-layer chain at alloc time;
* ``env``      — process-wide: only defaults and ``REPRO_ATTR_*`` apply
  (e.g. lock spin/backoff tuning, read at lock construction);
* ``readonly`` — runtime-discovered, never settable; served by per-instance
  providers.

Environment spelling: attribute ``eager_max_bytes`` reads
``REPRO_ATTR_EAGER_MAX_BYTES``.  Booleans accept 1/0/true/false/yes/no/
on/off.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Sequence, Tuple)

from .status import FatalError

ENV_PREFIX = "REPRO_ATTR_"

#: resolution layers, lowest to highest precedence
LAYERS = ("default", "env", "runtime", "resource")


class AttrError(FatalError, ValueError):
    """A bad attribute name or value.

    Subclasses both :class:`ValueError` (the natural Python spelling for
    argument validation) and :class:`~repro_torch.core.status.FatalError` (the
    paper's fatal-error category, which pre-attr call sites already
    catch), so every historical ``except``/``pytest.raises`` keeps
    working.
    """


@dataclasses.dataclass(frozen=True)
class AttrSpec:
    """One registry row: everything there is to know about a tunable."""

    name: str
    type: type                      # int | float | bool | str
    default: Any
    mutability: str = "alloc"       # "alloc" | "env" | "readonly"
    resources: Tuple[str, ...] = ()
    doc: str = ""
    choices: Optional[Tuple[str, ...]] = None
    minimum: Optional[float] = None
    # meaning of the zero value for int attrs where 0 is a sentinel
    # ("unbounded", "auto", "derive"); purely documentation
    zero_means: Optional[str] = None

    @property
    def env_var(self) -> str:
        return ENV_PREFIX + self.name.upper()

    # -- parsing / validation ------------------------------------------------
    def parse(self, raw: str) -> Any:
        """Parse an environment-variable string into the attr's type."""
        if self.type is bool:
            low = raw.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise AttrError(
                f"attribute {self.name!r}: cannot parse {self.env_var}="
                f"{raw!r} as bool (use 1/0/true/false/yes/no/on/off)")
        try:
            return self.type(raw)
        except (TypeError, ValueError) as e:
            raise AttrError(
                f"attribute {self.name!r}: cannot parse {self.env_var}="
                f"{raw!r} as {self.type.__name__}") from e

    def validate(self, value: Any) -> Any:
        """Check (and canonicalize) one value; raises naming the attr."""
        if self.type is float and isinstance(value, int) \
                and not isinstance(value, bool):
            value = float(value)
        if self.type is str:
            # enum-ish objects (CommMode) canonicalize through .value
            value = getattr(value, "value", value)
        if not isinstance(value, self.type) or (
                self.type is int and isinstance(value, bool)):
            raise AttrError(
                f"attribute {self.name!r} expects {self.type.__name__}, "
                f"got {value!r} ({type(value).__name__})")
        if self.choices is not None and value not in self.choices:
            raise AttrError(
                f"attribute {self.name!r}: unknown value {value!r}; pick "
                f"from {list(self.choices)}")
        if self.minimum is not None and value < self.minimum:
            raise AttrError(
                f"attribute {self.name!r} must be >= {self.minimum}, "
                f"got {value!r}")
        return value


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, AttrSpec] = {}

#: deprecated spellings accepted (with a DeprecationWarning) in attr
#: mappings — the pre-attr kwarg names CommConfig/alloc_* used to take
ALIASES: Dict[str, str] = {
    "inject_max_bytes": "eager_max_bytes",
    "bufcopy_max_bytes": "rdv_threshold",
    "capacity": "cq_capacity",
    "burst": "worker_burst",
}


def register_attr(name: str, type: type, default: Any, *,
                  mutability: str = "alloc",
                  resources: Sequence[str] = (), doc: str = "",
                  choices: Optional[Sequence[str]] = None,
                  minimum: Optional[float] = None,
                  zero_means: Optional[str] = None) -> AttrSpec:
    """Register one tunable; re-registration with identical fields is a
    no-op (module reloads), anything else is an error."""
    spec = AttrSpec(name=name, type=type, default=default,
                    mutability=mutability, resources=tuple(resources),
                    doc=doc,
                    choices=tuple(choices) if choices is not None else None,
                    minimum=minimum, zero_means=zero_means)
    old = REGISTRY.get(name)
    if old is not None and old != spec:
        raise AttrError(f"attribute {name!r} already registered with "
                        f"different spec")
    REGISTRY[name] = spec
    return spec


def get_spec(name: str) -> AttrSpec:
    spec = REGISTRY.get(name)
    if spec is None:
        raise AttrError(
            f"unknown attribute {name!r}; known attributes: "
            f"{sorted(REGISTRY)}")
    return spec


def canonical_name(name: str, *, warn: bool = True) -> str:
    """Map a (possibly deprecated) spelling onto the canonical attr name."""
    if name in ALIASES:
        if warn:
            warnings.warn(
                f"attribute spelling {name!r} is deprecated; use "
                f"{ALIASES[name]!r}", DeprecationWarning, stacklevel=3)
        return ALIASES[name]
    return name


def _canonicalize(mapping: Optional[Mapping[str, Any]],
                  *, warn: bool = True) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in (mapping or {}).items():
        out[canonical_name(key, warn=warn)] = value
    return out


# -- the stock attribute set (DESIGN.md §12 table) --------------------------
# runtime-wide protocol / resource-geometry knobs (CommConfig's fields)
register_attr("mode", str, "lci_dedicated",
              resources=("runtime", "cluster"),
              choices=("bsp", "lci_shared", "lci_dedicated"),
              doc="collective schedule mode (paper §5.2 evaluation axes)")
register_attr("n_channels", int, 4, minimum=1,
              resources=("runtime", "cluster", "device"),
              doc="chunk-streams per device (paper: resource replication)")
register_attr("eager_max_bytes", int, 64 * 1024, minimum=0,
              resources=("runtime", "cluster"),
              doc="largest payload sent through the inject (eager "
                  "descriptor) protocol")
register_attr("rdv_threshold", int, 2 * 1024 * 1024, minimum=0,
              resources=("runtime", "cluster"),
              doc="largest payload staged through buffer-copy packets; "
                  "above this the zero-copy rendezvous protocol engages")
register_attr("wire_bf16", bool, False,
              resources=("runtime", "cluster"),
              doc="compress float32 payloads to bf16 on the wire (fused "
                  "doorbell copy; delivered payloads are restored to f32) "
                  "and cast reduce-ring accumulators to bf16 per hop")
register_attr("doorbell_fused", bool, True,
              resources=("runtime", "cluster"),
              doc="fuse eager doorbells into packed single-descriptor "
                  "bursts (one stage-copy-push per doorbell); off = the "
                  "per-op scalar-burst data plane (DESIGN.md §13)")
register_attr("fused_min_burst", int, 4, minimum=2,
              resources=("runtime", "cluster"),
              doc="smallest run of uniform eager ops worth packing into "
                  "a fused doorbell; shorter runs ride the scalar-burst "
                  "path")
register_attr("matching_buckets", int, 65536, minimum=1,
              resources=("runtime", "cluster", "matching"),
              doc="matching-engine hash buckets (paper §4.1.3 default)")
register_attr("matching_locks", int, 64, minimum=1,
              resources=("runtime", "cluster", "matching"),
              doc="bucket-lock stripes guarding matching inserts")
register_attr("packets_per_lane", int, 64, minimum=1,
              resources=("runtime", "cluster", "pool"),
              doc="pre-registered packets seeded per pool lane")
register_attr("packet_bytes", int, 8192, minimum=0, zero_means="id-only",
              resources=("runtime", "cluster", "pool"),
              doc="fixed packet size — the buffer-copy staging "
                  "granularity; 0 = id-only pool with no backing buffers "
                  "(the paged-KV allocator)")
register_attr("pool_lanes", int, 0, minimum=0, zero_means="derive",
              resources=("runtime", "cluster", "pool"),
              doc="packet-pool lanes; 0 derives max(1, n_channels)")
# fabric / cluster
register_attr("fabric_backend", str, "sim",
              resources=("cluster", "fabric"),
              choices=("sim", "shm", "socket"),
              doc="transport backend behind the Fabric surface "
                  "(DESIGN.md §14): sim = deterministic in-process "
                  "deques, shm = shared-memory SPSC rings between OS "
                  "processes, socket = Unix-domain stream fallback")
register_attr("shm_ring_bytes", int, 1 << 20, minimum=4096,
              resources=("cluster", "fabric"),
              doc="data-region capacity of each shm ring buffer; "
                  "payloads above half this spill to side files")
register_attr("fabric_depth", int, 4096, minimum=1,
              resources=("cluster", "fabric"),
              doc="bounded per-(dst, device) wire-queue depth; a full "
                  "queue is the paper's §4.4 back-pressure event")
register_attr("link_latency", float, 0.0, minimum=0.0,
              resources=("cluster", "fabric"),
              doc="simulated wire latency in seconds (0 = instant fabric)")
# chaos plane (DESIGN.md §16): fault injection on the drain side of any
# transport backend — all zero/off by default (no ChaosTransport wrap)
register_attr("chaos_seed", int, 0, minimum=0,
              resources=("cluster", "fabric"),
              doc="base seed for the per-stream fault RNGs — same seed, "
                  "same fault decision sequence per (dst, device)")
register_attr("chaos_drop", float, 0.0, minimum=0.0,
              resources=("cluster", "fabric"),
              doc="probability a retransmittable (seq-stamped) eager "
                  "message is dropped at drain time")
register_attr("chaos_dup", float, 0.0, minimum=0.0,
              resources=("cluster", "fabric"),
              doc="probability a drained eager message is delivered twice")
register_attr("chaos_reorder", float, 0.0, minimum=0.0,
              resources=("cluster", "fabric"),
              doc="probability a drained eager message is held back and "
                  "delivered after the following drain batch")
register_attr("chaos_delay_p", float, 0.0, minimum=0.0,
              resources=("cluster", "fabric"),
              doc="probability a drained message takes a latency spike "
                  "of chaos_delay_us before delivery")
register_attr("chaos_delay_us", float, 1000.0, minimum=0.0,
              resources=("cluster", "fabric"),
              doc="latency-spike magnitude (microseconds) for messages "
                  "selected by chaos_delay_p")
register_attr("chaos_kill_rank", int, -1, minimum=-1,
              resources=("cluster", "fabric"),
              doc="declare this rank dead at the transport: all traffic "
                  "from/to it is dropped (-1 = nobody dies)")
# reliability protocol (DESIGN.md §16): seq/epoch stamping, unacked
# windows, retransmit — 'auto' turns it on exactly when chaos faults are
# active, so the default data plane pays nothing
register_attr("reliability", str, "auto",
              resources=("runtime", "cluster"),
              choices=("auto", "on", "off"),
              doc="eager-send retransmit protocol: on = stamp (seq, "
                  "epoch), ack cumulatively, retransmit on timeout; "
                  "auto = on only when chaos fault attrs are nonzero")
register_attr("post_deadline_us", float, 0.0, minimum=0.0,
              zero_means="no deadline",
              resources=("runtime", "cluster"),
              doc="deadline for tracked posts (send ack / recv match): "
                  "past it the op completes with err(ERR_TIMEOUT)")
register_attr("retry_limit", int, 16, minimum=1,
              resources=("runtime", "cluster"),
              doc="retransmits per unacked send before it completes "
                  "with err(ERR_TIMEOUT)")
register_attr("retry_backoff", float, 2e-3, minimum=1e-6,
              resources=("runtime", "cluster"),
              doc="base seconds between retransmits of one unacked "
                  "send (doubles per retry, capped at 16x)")
# per-device queues
register_attr("backlog_capacity", int, 0, minimum=0, zero_means="unbounded",
              resources=("device",),
              doc="backlog-queue bound; push past it surfaces "
                  "retry(RETRY_BACKLOG_FULL)")
register_attr("cq_capacity", int, 0, minimum=0, zero_means="unbounded",
              resources=("comp", "device"),
              doc="completion-queue bound; a full queue rejects signals "
                  "with retry(RETRY_QUEUE_FULL)")
# endpoint shape
register_attr("n_devices", int, 1, minimum=1,
              resources=("endpoint",),
              doc="devices striped under one endpoint (effective width)")
register_attr("stripe", str, "round_robin",
              resources=("endpoint",),
              choices=("round_robin", "by_peer", "by_size"),
              doc="which device each posted op rides (DESIGN.md §8)")
register_attr("progress", str, "shared",
              resources=("endpoint",),
              choices=("shared", "dedicated", "workers"),
              doc="who drives the endpoint's devices (DESIGN.md §8)")
# serving subsystem (DESIGN.md §17): the continuous-batching engine's
# paged KV geometry, prefill chunking, and client drain shape
register_attr("kv_page_tokens", int, 16, minimum=1,
              resources=("serving",),
              doc="tokens per KV-cache page — the paged allocator's "
                  "fixed page size (the packet pool's packet_bytes, in "
                  "token units)")
register_attr("kv_slots", int, 8, minimum=1,
              resources=("serving",),
              doc="decode slots — concurrent requests resident in the "
                  "batch (JetStream-style slot array width)")
register_attr("kv_pages", int, 0, minimum=0, zero_means="8 * kv_slots",
              resources=("serving",),
              doc="total KV pages backing the slot array; 0 derives "
                  "8 pages per slot")
register_attr("kv_evict", str, "refuse",
              resources=("serving",),
              choices=("refuse", "preempt_longest"),
              doc="admission policy under page/slot exhaustion: refuse = "
                  "retry(RETRY_NOSLOT) and park in the backlog; "
                  "preempt_longest = evict the active request with the "
                  "largest footprint back to the backlog (its pages free, "
                  "its token stream resumes after re-prefill)")
register_attr("prefill_chunk", int, 32, minimum=1,
              resources=("serving",),
              doc="prompt tokens prefilled per completion-graph node — "
                  "bounds how long a long prompt can monopolize a tick "
                  "before decode interleaves")
register_attr("drain_workers", int, 2, minimum=1,
              resources=("serving",),
              doc="client-side ResultDrain worker threads popping the "
                  "thread-safe result CQ")
register_attr("max_batch", int, 0, minimum=0, zero_means="kv_slots",
              resources=("serving",),
              doc="admission bound on concurrently active requests; "
                  "0 derives kv_slots")
# progress workers
register_attr("n_workers", int, 0, minimum=0, zero_means="auto",
              resources=("endpoint", "workers"),
              doc="progress worker threads; 0 = one per device "
                  "(endpoint) / the pool default of 2")
register_attr("worker_burst", int, 64, minimum=0, zero_means="unbounded",
              resources=("endpoint", "workers"),
              doc="wire messages drained per progress-lock acquisition "
                  "(paper §4.3 burst progress)")
# observability (DESIGN.md §15)
register_attr("telemetry_level", str, "off",
              resources=("runtime", "cluster"),
              choices=("off", "counters", "timers", "trace"),
              doc="observability depth: counters = sharded metric "
                  "registry, timers = stage-scoped spans on every hot "
                  "path, trace = ring-buffer event trace with Chrome "
                  "export; off compiles the whole plane away")
register_attr("trace_capacity", int, 4096, minimum=1,
              resources=("runtime", "cluster"),
              doc="per-thread event capacity of the trace ring buffer "
                  "(old events are overwritten FIFO)")
# lock tuning — process-wide (read at lock construction): env mutability
register_attr("lock_spin_count", int, 4, minimum=0, mutability="env",
              resources=("lock",),
              doc="pure spins before a blocking acquire starts backing off")
register_attr("lock_backoff_max", float, 1e-3, minimum=0.0,
              mutability="env", resources=("lock",),
              doc="cap (seconds) of the blocking-acquire backoff sleep")

# read-only runtime-discovered attributes (served by per-instance
# providers; listed here so the registry table is the one place that
# names every attribute)
register_attr("width", int, None, mutability="readonly",
              resources=("endpoint", "device"),
              doc="effective width: devices in the bundle / channels on "
                  "the device")
register_attr("contention", dict, None, mutability="readonly",
              resources=("endpoint", "pool", "matching", "workers"),
              doc="aggregated lock telemetry (acquisitions/contentions/"
                  "spins)")
register_attr("free_packets", int, None, mutability="readonly",
              resources=("runtime", "pool"),
              doc="packets currently available across all pool lanes")
register_attr("in_flight", int, None, mutability="readonly",
              resources=("fabric",),
              doc="wire messages queued (including not-yet-drainable)")
register_attr("rank_me", int, None, mutability="readonly",
              resources=("runtime",), doc="this runtime's rank")
register_attr("rank_n", int, None, mutability="readonly",
              resources=("runtime", "cluster"),
              doc="total ranks in the cluster")
register_attr("telemetry", dict, None, mutability="readonly",
              resources=("runtime", "cluster", "device", "endpoint",
                         "pool", "matching", "comp", "workers", "fabric"),
              doc="live telemetry snapshot for this resource (merged "
                  "counters; runtimes/clusters add stage-span histograms)")


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

class ResolvedAttrs(Mapping):
    """The outcome of one resolution: value + provenance per attribute.

    Mapping-like over the resolved values; :meth:`source` reports which
    layer won (``default``/``env``/``runtime``/``resource``).
    """

    __slots__ = ("_values", "_sources")

    def __init__(self, values: Dict[str, Any], sources: Dict[str, str]):
        self._values = dict(values)
        self._sources = dict(sources)

    def __getitem__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttrError(
                f"unknown attribute {name!r}; resolved attributes: "
                f"{sorted(self._values)}") from None

    def __contains__(self, name: object) -> bool:
        return name in self._values

    def __iter__(self):
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def source(self, name: str) -> str:
        self[name]                       # raise the naming error on unknown
        return self._sources[name]

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def echo(self) -> Dict[str, Dict[str, Any]]:
        """JSON-serializable {values, sources} block — every BENCH_*.json
        carries one so perf numbers always name their configuration."""
        return {"values": {k: _jsonable(v) for k, v in self._values.items()},
                "sources": dict(self._sources)}

    def merged(self, other: "ResolvedAttrs") -> "ResolvedAttrs":
        values = {**self._values, **other._values}
        sources = {**self._sources, **other._sources}
        return ResolvedAttrs(values, sources)

    def subset(self, names: Iterable[str]) -> "ResolvedAttrs":
        """Restrict to ``names`` (provenance preserved) — hands a child
        resource its slice of a wider resolution."""
        names = [n for n in names if n in self._values]
        return ResolvedAttrs({n: self._values[n] for n in names},
                             {n: self._sources[n] for n in names})

    def __repr__(self) -> str:
        rows = ", ".join(f"{k}={self._values[k]!r}<-{self._sources[k]}"
                         for k in sorted(self._values))
        return f"ResolvedAttrs({rows})"


def _jsonable(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return getattr(v, "value", str(v))


def resolve(names: Optional[Iterable[str]] = None, *,
            runtime: Optional[Mapping[str, Any]] = None,
            overrides: Optional[Mapping[str, Any]] = None,
            env: Optional[Mapping[str, str]] = None) -> ResolvedAttrs:
    """Run the four-layer chain for ``names`` (default: every ``alloc``
    attr).

    ``runtime`` is the runtime-level config layer (e.g. the merged
    ``LocalCluster(attrs=...)`` mapping) — keys outside ``names`` are
    ignored (they belong to other resources) but must exist in the
    registry.  ``overrides`` are per-resource alloc-time arguments — every
    key must be in ``names`` (an unknown override is a caller bug and
    raises, naming the attribute).  ``env`` defaults to ``os.environ``;
    pass a mapping to make resolution hermetic (tests).
    """
    if names is None:
        names = [n for n, s in REGISTRY.items() if s.mutability == "alloc"]
    names = list(names)
    env = os.environ if env is None else env
    runtime = _canonicalize(runtime)
    overrides = _canonicalize(overrides)

    for key in runtime:
        if get_spec(key).mutability != "alloc":    # unknown -> AttrError
            raise AttrError(
                f"attribute {key!r} is {get_spec(key).mutability}; it "
                "cannot be set through the runtime config layer")
    for key in overrides:
        if key not in names:
            valid = sorted(n for n in names
                           if get_spec(n).mutability == "alloc")
            raise AttrError(
                f"unknown attribute override {key!r} for this resource; "
                f"valid attributes: {valid}")
        if get_spec(key).mutability != "alloc":
            raise AttrError(
                f"attribute {key!r} is {get_spec(key).mutability}; it "
                "cannot be overridden at alloc time")

    values: Dict[str, Any] = {}
    sources: Dict[str, str] = {}
    for name in names:
        spec = get_spec(name)
        if spec.mutability == "readonly":
            raise AttrError(
                f"attribute {name!r} is read-only (runtime-discovered); "
                "query it on a live resource with get_attr")
        value, source = spec.default, "default"
        raw = env.get(spec.env_var)
        if raw is not None:
            value, source = spec.parse(raw), "env"
        if spec.mutability == "alloc":
            if name in runtime:
                value, source = runtime[name], "runtime"
            if name in overrides:
                value, source = overrides[name], "resource"
        values[name] = spec.validate(value)
        sources[name] = source
    return ResolvedAttrs(values, sources)


_RESOLVE_ONE_MEMO: Dict[Tuple[str, Optional[str]], Any] = {}


def resolve_one(name: str, *, runtime: Optional[Mapping[str, Any]] = None,
                overrides: Optional[Mapping[str, Any]] = None,
                env: Optional[Mapping[str, str]] = None) -> Any:
    """Shorthand: run the chain for one attribute, return its value.

    The bare defaults+env form is memoized per (attr, raw env string) —
    it sits on construction paths that run hundreds of times per cluster
    (every :class:`TryLock` reads the lock tuning), and re-running the
    chain there only produces allocation churn.  A changed env var still
    takes effect (it changes the memo key)."""
    if runtime is None and overrides is None and env is None:
        key = (name, os.environ.get(ENV_PREFIX + name.upper()))
        if key not in _RESOLVE_ONE_MEMO:
            _RESOLVE_ONE_MEMO[key] = resolve([name])[name]
        return _RESOLVE_ONE_MEMO[key]
    return resolve([name], runtime=runtime, overrides=overrides, env=env)[name]


def resolved_from_values(values: Mapping[str, Any],
                         source: str = "resource") -> ResolvedAttrs:
    """Wrap already-final values (a directly-constructed resource that
    bypassed the chain) so introspection still works, with validation."""
    out: Dict[str, Any] = {}
    for key, value in _canonicalize(values, warn=False).items():
        out[key] = get_spec(key).validate(value)
    return ResolvedAttrs(out, {k: source for k in out})


# ---------------------------------------------------------------------------
# the introspection mixin
# ---------------------------------------------------------------------------

class AttrResource:
    """Gives a resource object the LCI ``get_attr`` surface.

    Call :meth:`_init_attrs` once during construction with the resolved
    tunables; register read-only discovered attributes (effective widths,
    telemetry) with :meth:`_export_attr`.  ``get_attr(name)`` serves
    providers first (they shadow nothing — readonly names are distinct by
    convention), then resolved tunables; ``.attrs`` snapshots everything.
    """

    _resolved_attrs: ResolvedAttrs
    _attr_providers: Dict[str, Callable[[], Any]]

    def _init_attrs(self, resolved: Optional[ResolvedAttrs] = None) -> None:
        # object.__setattr__: some resources are frozen dataclasses
        # (CommConfig, EndpointSpec) wiring this up from __post_init__
        object.__setattr__(self, "_resolved_attrs",
                           resolved or ResolvedAttrs({}, {}))
        object.__setattr__(self, "_attr_providers", {})

    def _ensure_attrs(self) -> None:
        """Lazy init: a subclass that never called :meth:`_init_attrs`
        (e.g. a bare completion object) still introspects cleanly."""
        if not hasattr(self, "_attr_providers"):
            self._init_attrs()

    def _export_attr(self, name: str, provider: Callable[[], Any]) -> None:
        """Register one read-only runtime-discovered attribute."""
        self._ensure_attrs()
        self._attr_providers[name] = provider

    def get_attr(self, name: str) -> Any:
        """Query one attribute by name (LCI's ``get_attr_*`` surface)."""
        self._ensure_attrs()
        name = canonical_name(name)
        provider = self._attr_providers.get(name)
        if provider is not None:
            return provider()
        if name in self._resolved_attrs:
            return self._resolved_attrs[name]
        raise AttrError(
            f"{type(self).__name__} has no attribute {name!r}; available: "
            f"{sorted([*self._resolved_attrs, *self._attr_providers])}")

    def attr_source(self, name: str) -> str:
        """Which layer produced an attribute ("discovered" = readonly)."""
        self._ensure_attrs()
        name = canonical_name(name)
        if name in self._attr_providers:
            return "discovered"
        return self._resolved_attrs.source(name)

    @property
    def attrs(self) -> Dict[str, Any]:
        """Snapshot of every attribute this resource exposes."""
        self._ensure_attrs()
        out = self._resolved_attrs.as_dict()
        for name, provider in self._attr_providers.items():
            out[name] = provider()
        return out

    def attrs_echo(self) -> Dict[str, Dict[str, Any]]:
        """The BENCH-JSON echo block: tunables with provenance, plus the
        discovered attributes under source "discovered"."""
        self._ensure_attrs()
        echo = self._resolved_attrs.echo()
        for name, provider in self._attr_providers.items():
            echo["values"][name] = _jsonable(provider())
            echo["sources"][name] = "discovered"
        return echo


def parse_attr_args(pairs: Iterable[str]) -> Dict[str, Any]:
    """Parse CLI ``name=value`` pairs into a validated attrs mapping
    (launchers' ``--attr`` flag).  Values parse like env overrides."""
    out: Dict[str, Any] = {}
    for pair in pairs:
        name, sep, raw = pair.partition("=")
        if not sep:
            raise AttrError(f"--attr expects name=value, got {pair!r}")
        spec = get_spec(canonical_name(name.strip()))
        out[spec.name] = spec.validate(spec.parse(raw.strip()))
    return out


# ---------------------------------------------------------------------------
# documentation helper
# ---------------------------------------------------------------------------

def registry_table() -> str:
    """Render the registry as the DESIGN.md §12 markdown table."""
    rows = ["| attribute | type | default | mutability | resources | "
            "meaning |",
            "|---|---|---|---|---|---|"]
    for name in sorted(REGISTRY):
        s = REGISTRY[name]
        default = repr(s.default)
        if s.zero_means:
            default += f" (0 = {s.zero_means})"
        doc = s.doc
        if s.choices:
            doc += f" — one of {'/'.join(s.choices)}"
        rows.append(f"| `{name}` | {s.type.__name__} | {default} | "
                    f"{s.mutability} | {', '.join(s.resources)} | {doc} |")
    return "\n".join(rows)
