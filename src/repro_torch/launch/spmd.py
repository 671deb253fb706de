"""SPMD launcher — N OS-process ranks over a cross-process transport.

The paper's evaluation compares its multithreaded runtime against the
traditional *multi-process* execution mode (Figures 2/3); this launcher
provides that mode.  It forks N copies of a program (a built-in
message-window demo by default, or any command after ``--``), wires the
bootstrap exchange, and owns teardown:

* **bootstrap** — rank / world-size / session discovery rides the
  environment (``REPRO_SPMD_RANK`` / ``REPRO_SPMD_NRANKS`` /
  ``REPRO_SPMD_SESSION``); the session is a directory both sides derive
  ring-file and socket paths from, so no fd passing or port exchange is
  needed.  :func:`bootstrap` reads it back in the child and returns the
  :class:`SpmdContext`.
* **barrier** — an mmap'd file of per-rank generation counters in the
  session dir (one 64-byte line per rank, single-writer each — the same
  SPSC discipline as the shm rings).  ``ctx.barrier()`` bumps my counter
  and spins (with sleep backoff and a timeout) until every rank reaches
  my generation.
* **teardown** — every child runs in its own process group
  (``start_new_session``); when any rank dies, the launcher SIGTERMs the
  surviving groups, escalates to SIGKILL after a grace period, reaps
  everything, removes the session dir, and exits nonzero.  Joins are
  timeout-bounded — a wedged rank cannot hang the launcher.

The environment names (``REPRO_SPMD_*``, ``REPRO_ATTR_*``), the barrier
and heartbeat files and the wire frames are the reference launcher's
(``repro.launch.spmd``), so ranks of either package can join one
session.  The built-in demos bind each rank to ``--device`` (the card
unless ``--device cpu``) and build their payloads there; a CUDA payload
crosses to the host once a frame in the codec.

Usage::

    python -m repro_torch.launch.spmd --ranks 2 --backend shm
    python -m repro_torch.launch.spmd --ranks 2 --backend shm --device cpu
    python -m repro_torch.launch.spmd --ranks 2 --backend shm \\
        --attr fabric_depth=1024 -- python my_rank_program.py
"""
from __future__ import annotations

import argparse
import mmap
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

RANK_ENV = "REPRO_SPMD_RANK"
NRANKS_ENV = "REPRO_SPMD_NRANKS"
SESSION_ENV = "REPRO_SPMD_SESSION"

_SLOT = 64                       # one cache line per rank counter
_BARRIER_FILE = "barrier"
_HB_FILE = "heartbeat"
_HB = struct.Struct("<Qd")       # [beat count][wall-clock stamp]


def _store(mm: mmap.mmap, off: int, raw: bytes) -> None:
    """Write a slot in one copy (``struct.pack_into`` zero-fills its
    target first and stores byte by byte: a peer reading meanwhile sees
    a torn value)."""
    mm[off:off + len(raw)] = raw


def _default_session_root(backend: str) -> str:
    if backend == "shm" and os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return tempfile.gettempdir()


@dataclass
class SpmdContext:
    """One rank's view of the SPMD job (from :func:`bootstrap`)."""
    rank: int
    n_ranks: int
    session: str                 # absolute session-dir path
    _mm: Optional[mmap.mmap] = field(default=None, repr=False)
    _gen: int = 0
    _hb: Optional[mmap.mmap] = field(default=None, repr=False)
    _beats: int = 0
    #: rank -> (its heartbeat slot's bytes, when I first saw them)
    _seen: Dict[int, tuple] = field(default_factory=dict, repr=False)

    def _slot_mm(self, attr: str, filename: str) -> mmap.mmap:
        if getattr(self, attr) is None:
            path = os.path.join(self.session, filename)
            size = _SLOT * self.n_ranks
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            try:
                os.ftruncate(fd, size)   # idempotent fixed size
                setattr(self, attr, mmap.mmap(fd, size))
            finally:
                os.close(fd)
        return getattr(self, attr)

    def _barrier_mm(self) -> mmap.mmap:
        return self._slot_mm("_mm", _BARRIER_FILE)

    def barrier(self, timeout: float = 30.0) -> None:
        """Block until every rank reaches this barrier (generation
        counters: my slot is mine to write, peers' slots mine to read)."""
        mm = self._barrier_mm()
        self._gen += 1
        _store(mm, _SLOT * self.rank, struct.pack("<Q", self._gen))
        deadline = time.monotonic() + timeout
        nap = 1e-6
        while True:
            done = all(
                int.from_bytes(mm[_SLOT * r:_SLOT * r + 8], "little")
                >= self._gen
                for r in range(self.n_ranks))
            if done:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"rank {self.rank}: barrier generation {self._gen} "
                    f"timed out after {timeout}s")
            time.sleep(nap)
            nap = min(nap * 2, 1e-3)

    # -- heartbeats: the failure-detector input (DESIGN.md §16) ---------
    # Same single-writer slot discipline as the barrier: my 64-byte slot
    # carries [u64 beat count][f64 wall-clock stamp]; peers only read it.
    # The launcher reads the same file to time chaos kills, and survivors
    # read it to declare a silent rank dead.

    def _hb_mm(self) -> mmap.mmap:
        return self._slot_mm("_hb", _HB_FILE)

    def heartbeat(self) -> int:
        """Publish liveness: bump my beat count, stamp the wall clock."""
        mm = self._hb_mm()
        self._beats += 1
        _store(mm, _SLOT * self.rank, _HB.pack(self._beats, time.time()))
        return self._beats

    def peer_heartbeats(self) -> List[tuple]:
        """``[(beat_count, last_stamp), ...]`` indexed by rank."""
        mm = self._hb_mm()
        return [_HB.unpack(mm[_SLOT * r:_SLOT * r + _HB.size])
                for r in range(self.n_ranks)]

    def dead_ranks(self, timeout: float = 2.0) -> List[int]:
        """Ranks that heartbeat at least once, then went silent for more
        than ``timeout`` seconds.  A rank that never beat is still
        booting, not dead — liveness starts at the first beat.

        Silence is timed on this rank's clock, from the first time it
        saw a peer's slot as it stands: any change of the slot is a
        beat.  The stamp in the slot is not read, because a rank of the
        reference package writes it with ``struct.pack_into``, which
        zero-fills the slot and stores byte by byte — a read racing that
        write sees a stamp from 1970 and would declare a live rank
        dead."""
        now = time.monotonic()
        mm = self._hb_mm()
        dead = []
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            raw = mm[_SLOT * r:_SLOT * r + _HB.size]
            seen = self._seen.get(r)
            if seen is None or seen[0] != raw:
                self._seen[r] = (raw, now)
            elif _HB.unpack(raw)[0] > 0 and now - seen[1] > timeout:
                dead.append(r)
        return dead

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._hb is not None:
            self._hb.close()
            self._hb = None


def bootstrap() -> SpmdContext:
    """Child-side bootstrap: recover rank identity from the launcher's
    environment.  Raises if not running under the launcher."""
    rank = os.environ.get(RANK_ENV)
    if rank is None:
        raise RuntimeError(
            "bootstrap(): not an SPMD child (REPRO_SPMD_RANK unset); "
            "run under `python -m repro_torch.launch.spmd`")
    return SpmdContext(rank=int(rank),
                       n_ranks=int(os.environ[NRANKS_ENV]),
                       session=os.environ[SESSION_ENV])


# ---------------------------------------------------------------------------
# host hygiene: leftovers of dead SPMD jobs skew every timing they share
# a machine with (an orphaned rank spins a core; a stale /dev/shm session
# holds ring memory).  The launcher warns and proceeds.
# ---------------------------------------------------------------------------

def _spmd_procs() -> List[Dict]:
    """Live processes bootstrapped by this launcher: any process whose
    environment carries ``REPRO_SPMD_SESSION`` (Linux /proc scan; empty
    elsewhere).  Returns ``{pid, ppid, session}`` per process."""
    procs: List[Dict] = []
    try:
        pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return procs
    needle = (SESSION_ENV + "=").encode()
    me = os.getpid()
    for pid in pids:
        if pid == me:
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue                 # exited, or not ours to read
        session = None
        for chunk in env.split(b"\0"):
            if chunk.startswith(needle):
                session = chunk[len(needle):].decode("utf-8", "replace")
                break
        if session is None:
            continue
        ppid = -1
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            # comm (field 2) may embed spaces/parens; ppid is the second
            # field after the closing paren
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            pass
        procs.append({"pid": pid, "ppid": ppid, "session": session})
    return procs


def hygiene_report(roots: Optional[Sequence[str]] = None) -> Dict:
    """Audit the host for leftovers of dead SPMD jobs.

    * **orphans** — rank processes whose launcher died (reparented to
      init, ``ppid == 1``).  They spin in posting/progress loops and eat
      a core each, skewing any wall-clock measured beside them.
    * **stale sessions** — ``repro-spmd-*`` dirs under ``roots``
      (default: /dev/shm and the tempdir) referenced by no live rank;
      teardown was skipped (SIGKILLed launcher), and on /dev/shm the
      ring files pin memory.

    Returns ``{"clean": bool, "orphans": [...], "stale_sessions":
    [...]}``.  Sessions of live non-orphan jobs are neither — a
    concurrent healthy run is not a hygiene problem.
    """
    procs = _spmd_procs()
    orphans = [p for p in procs if p["ppid"] == 1]
    referenced = {os.path.abspath(p["session"]) for p in procs}
    if roots is None:
        roots = ("/dev/shm", tempfile.gettempdir())
    stale: List[str] = []
    seen_roots = set()
    for root in roots:
        root = os.path.abspath(root)
        if root in seen_roots or not os.path.isdir(root):
            continue
        seen_roots.add(root)
        try:
            names = os.listdir(root)
        except OSError:
            continue
        for name in names:
            if not name.startswith("repro-spmd-"):
                continue
            path = os.path.join(root, name)
            if os.path.isdir(path) and path not in referenced:
                stale.append(path)
    return {"clean": not orphans and not stale,
            "orphans": orphans,
            "stale_sessions": sorted(stale)}


def preflight(roots: Optional[Sequence[str]] = None) -> Dict:
    """Hygiene check run before launching: prints one line per finding
    (orphaned ranks, stale session dirs) and proceeds."""
    rep = hygiene_report(roots)
    for p in rep["orphans"]:
        print(f"spmd: orphaned rank pid={p['pid']} "
              f"(launcher dead, session {p['session']})", file=sys.stderr)
    for path in rep["stale_sessions"]:
        print(f"spmd: stale session dir {path} (no live ranks; teardown "
              f"was skipped)", file=sys.stderr)
    return rep


# ---------------------------------------------------------------------------
# launcher (parent side)
# ---------------------------------------------------------------------------

def _child_env(rank: int, n_ranks: int, session: str, backend: str,
               attr_overrides: Dict[str, str],
               extra: Dict[str, str]) -> Dict[str, str]:
    env = {**os.environ, **extra}
    env[RANK_ENV] = str(rank)
    env[NRANKS_ENV] = str(n_ranks)
    env[SESSION_ENV] = session
    env["REPRO_ATTR_FABRIC_BACKEND"] = backend
    for name, value in attr_overrides.items():
        env[f"REPRO_ATTR_{name.upper()}"] = value
    return env


def _kill_group(proc: subprocess.Popen, sig: int) -> None:
    try:
        os.killpg(proc.pid, sig)     # child is its own session/group leader
    except (ProcessLookupError, PermissionError):
        pass


def _reap(procs: Sequence[subprocess.Popen], grace: float = 5.0) -> None:
    """Terminate every surviving process group; escalate to SIGKILL."""
    for p in procs:
        if p.poll() is None:
            _kill_group(p, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            _kill_group(p, signal.SIGKILL)
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass                 # unkillable (D-state); reported below


def _all_beating(session: str, n_ranks: int) -> bool:
    """Launcher-side read of the heartbeat file: every rank beat >= once."""
    path = os.path.join(session, _HB_FILE)
    try:
        with open(path, "rb") as f:
            raw = f.read(_SLOT * n_ranks)
    except OSError:
        return False
    if len(raw) < _SLOT * n_ranks:
        return False
    return all(_HB.unpack_from(raw, _SLOT * r)[0] > 0
               for r in range(n_ranks))


def launch(cmd: List[str], n_ranks: int, backend: str = "shm",
           attr_overrides: Optional[Dict[str, str]] = None,
           timeout: float = 120.0, session: Optional[str] = None,
           kill_rank: Optional[int] = None, kill_after: float = 1.0,
           env: Optional[Dict[str, str]] = None) -> int:
    """Fork ``cmd`` N times with SPMD bootstrap env; returns the exit
    code (0 only if every rank exited 0 within ``timeout``).  ``env``
    adds to (or overrides) the environment the ranks inherit.

    ``kill_rank`` arms the chaos kill: once every rank has heartbeat at
    least once, wait ``kill_after`` seconds and SIGKILL that rank's
    process group.  Its death is then *expected* — the launcher does not
    tear the survivors down, and success means every OTHER rank exited 0
    (the rank-death recovery contract, DESIGN.md §16).
    """
    preflight()                      # warn about leftovers of dead jobs
    if kill_rank is not None and not 0 <= kill_rank < n_ranks:
        raise ValueError(f"kill_rank {kill_rank} out of range")
    owns_session = session is None
    if owns_session:
        session = tempfile.mkdtemp(prefix="repro-spmd-",
                                   dir=_default_session_root(backend))
    session = os.path.abspath(session)
    os.makedirs(session, exist_ok=True)
    procs: List[subprocess.Popen] = []
    code = 0
    try:
        for rank in range(n_ranks):
            procs.append(subprocess.Popen(
                cmd, env=_child_env(rank, n_ranks, session, backend,
                                    attr_overrides or {}, env or {}),
                start_new_session=True))
        deadline = time.monotonic() + timeout
        live = list(procs)
        victim = procs[kill_rank] if kill_rank is not None else None
        killed = False
        all_alive_at: Optional[float] = None
        while live:
            if victim is not None and not killed:
                if all_alive_at is None and _all_beating(session, n_ranks):
                    all_alive_at = time.monotonic()
                if all_alive_at is not None and \
                        time.monotonic() >= all_alive_at + kill_after:
                    print(f"spmd: chaos-kill SIGKILL rank {kill_rank}",
                          file=sys.stderr)
                    _kill_group(victim, signal.SIGKILL)
                    killed = True
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if p is victim and killed:
                    continue         # expected death; survivors run on
                if rc != 0:
                    rank = procs.index(p)
                    print(f"spmd: rank {rank} exited with {rc}; "
                          f"tearing down {len(live)} surviving ranks",
                          file=sys.stderr)
                    code = rc if rc > 0 else 1
                    live = []
                    break
            if time.monotonic() >= deadline:
                print(f"spmd: timeout after {timeout}s; killing all ranks",
                      file=sys.stderr)
                code = code or 124
                break
            if live:
                time.sleep(0.02)
        if victim is not None and not killed and code == 0:
            # victim finished before the kill ever armed/fired — the
            # chaos run proved nothing; fail loudly rather than greenly
            print("spmd: chaos-kill never fired (job too short?)",
                  file=sys.stderr)
            code = 1
    finally:
        _reap(procs)
        if owns_session:
            shutil.rmtree(session, ignore_errors=True)
    return code


# ---------------------------------------------------------------------------
# built-in demo program: a cross-process message-rate window
# ---------------------------------------------------------------------------

def _payload(size: int, device):
    """The demos' payload, ``arange(size)`` as bytes (the reference's
    bytes), built on the rank's device."""
    import torch
    return torch.arange(size, device=device).to(torch.uint8)


def _run_demo(window: int, iters: int, size: int, device=None) -> int:
    """Each rank posts ``window`` eager AMs per iteration to its ring
    neighbor and progresses until the window completes — the message-rate
    kernel cross-process.  Exits nonzero on lost or leaked messages."""
    from repro_torch.core import ProcessCluster, post_am

    ctx = bootstrap()
    backend = os.environ.get("REPRO_ATTR_FABRIC_BACKEND", "shm")
    cluster = ProcessCluster(ctx.n_ranks, ctx.rank,
                             fabric_backend=backend, session=ctx.session,
                             device=device)
    rt = cluster.runtime
    cq = rt.alloc_cq()
    rt.register_rcomp(cq)        # symmetric alloc: rcomp index 0 everywhere
    peer = (ctx.rank + 1) % ctx.n_ranks
    buf = _payload(size, rt.device)
    got = 0

    # a rank must never outlive its job: if the launcher is SIGKILLed its
    # teardown cannot run, and a peer-less rank would spin in the posting
    # retry loop forever.  Orphan check (reparented => launcher died) plus
    # a hard wall-clock bound make every loop below self-terminating.
    ppid0 = os.getppid()
    hard_deadline = time.monotonic() + float(
        os.environ.get("REPRO_SPMD_DEADLINE", "600"))

    def check_alive() -> None:
        if os.getppid() != ppid0:
            print(f"spmd-demo rank {ctx.rank}: launcher died; exiting",
                  file=sys.stderr)
            os._exit(2)
        if time.monotonic() > hard_deadline:
            print(f"spmd-demo rank {ctx.rank}: hard deadline exceeded",
                  file=sys.stderr)
            os._exit(3)

    ctx.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        posted = 0
        while posted < window:
            st = post_am(rt, peer, buf, remote_comp=0)
            if not st.is_retry():
                posted += 1
            else:
                check_alive()
                rt.progress()
            while cq.pop().is_done():
                got += 1
        # finish the iteration's own sends; peer deliveries keep landing
        # (ring back-pressure — not peer lockstep — is the flow control)
        spin_deadline = time.monotonic() + 10.0
        while rt.pending_ops and time.monotonic() < spin_deadline:
            check_alive()
            rt.progress()
            while cq.pop().is_done():
                got += 1
    # drain until every rank's deliveries arrived (peer may lag)
    expect = window * iters
    spin_deadline = time.monotonic() + 30.0
    while got < expect and time.monotonic() < spin_deadline:
        check_alive()
        rt.progress()
        while cq.pop().is_done():
            got += 1
    elapsed = time.perf_counter() - t0
    # cooldown: our receives being done says nothing about our *sends* —
    # under chaos a dropped message to the peer is only retransmitted by
    # OUR progress calls, so keep driving until the peer acked everything
    # (otherwise the peer spins out its drain deadline and reports lost)
    spin_deadline = time.monotonic() + 30.0
    while rt.rel is not None and rt.rel.busy() \
            and time.monotonic() < spin_deadline:
        check_alive()
        rt.progress()
        while cq.pop().is_done():
            got += 1
    ctx.barrier()
    lost = expect - got
    leaked = cluster.fabric.in_flight()
    rate = expect / elapsed if elapsed > 0 else float("inf")
    print(f"spmd-demo rank {ctx.rank}: {expect} msgs in {elapsed:.3f}s "
          f"({rate:,.0f} msg/s) on {rt.device} lost={lost} leaked={leaked}")
    cluster.close()
    ctx.close()
    return 0 if lost == 0 and leaked == 0 else 1


def _run_chaos_demo(size: int, kill_rank: int, hb_timeout: float,
                    device=None) -> int:
    """Rank-death detection and drain end to end (DESIGN.md §16): every
    rank streams eager AMs to its ring neighbor and heartbeats; the
    launcher SIGKILLs ``kill_rank`` mid-stream.  Survivors detect the
    silence and mark the peer dead, and every outstanding post completes
    (ERR_PEER_DEAD) — no hang.  Survivor exit 0 is the proof; the
    launcher treats the victim's death as expected.

    The reference goes on to shrink the mesh and restore a checkpoint
    resharded onto it; that needs the port's checkpoint store and
    elastic layer (the training stack), so this demo stops after the
    drain."""
    from repro_torch.core import ProcessCluster, post_am
    from repro_torch.core.status import ErrorCode

    ctx = bootstrap()
    backend = os.environ.get("REPRO_ATTR_FABRIC_BACKEND", "shm")
    cluster = ProcessCluster(ctx.n_ranks, ctx.rank,
                             fabric_backend=backend, session=ctx.session,
                             device=device)
    rt = cluster.runtime
    cq = rt.alloc_cq()
    rt.register_rcomp(cq)        # symmetric alloc: rcomp index 0 everywhere
    scq = rt.alloc_cq()          # send-side completions (done / err)
    peer = (ctx.rank + 1) % ctx.n_ranks
    buf = _payload(size, rt.device)

    ppid0 = os.getppid()
    hard_deadline = time.monotonic() + float(
        os.environ.get("REPRO_SPMD_DEADLINE", "120"))

    def check_alive() -> None:
        if os.getppid() != ppid0:
            print(f"spmd-chaos rank {ctx.rank}: launcher died; exiting",
                  file=sys.stderr)
            os._exit(2)
        if time.monotonic() > hard_deadline:
            print(f"spmd-chaos rank {ctx.rank}: hard deadline exceeded",
                  file=sys.stderr)
            os._exit(3)

    counts = {"done": 0, "delivered": 0, "peer_dead": 0, "timeout": 0,
              "other": 0}

    def drain() -> None:
        for q, done_key in ((scq, "done"), (cq, "delivered")):
            while True:
                st = q.pop()
                if st.is_done():
                    counts[done_key] += 1
                elif st.is_err():
                    if st.code == ErrorCode.ERR_PEER_DEAD:
                        counts["peer_dead"] += 1
                    elif st.code == ErrorCode.ERR_TIMEOUT:
                        counts["timeout"] += 1
                    else:
                        counts["other"] += 1
                else:
                    break            # empty (retry status)

    ctx.heartbeat()
    ctx.barrier()                    # all booted

    dead: List[int] = []
    t0 = time.monotonic()
    while not dead:
        check_alive()
        ctx.heartbeat()
        dead = ctx.dead_ranks(hb_timeout)
        st = post_am(rt, peer, buf, local_comp=scq, remote_comp=0)
        if st.is_retry():
            rt.progress()
        drain()

    t_detect = time.monotonic()
    for r in dead:
        rt.mark_peer_dead(r)
    print(f"spmd-chaos rank {ctx.rank}: peer(s) {dead} dead "
          f"(silent > {hb_timeout}s at t+{t_detect - t0:.2f}s)",
          file=sys.stderr)

    # every outstanding post must complete (ERR_PEER_DEAD), not hang
    spin_deadline = time.monotonic() + 10.0
    while rt.pending_ops and time.monotonic() < spin_deadline:
        check_alive()
        rt.progress()
        drain()
    drain()
    hung = len(rt.pending_ops)
    drain_ms = (time.monotonic() - t_detect) * 1e3

    print(f"spmd-chaos rank {ctx.rank}: drained in {drain_ms:.0f}ms "
          f"on {rt.device} sent={counts['done']} "
          f"delivered={counts['delivered']} "
          f"peer_dead={counts['peer_dead']} timeout={counts['timeout']} "
          f"other={counts['other']} hung={hung}")
    rel = rt.rel.counters() if rt.rel is not None else {}
    if rel:
        print(f"spmd-chaos rank {ctx.rank}: rel retransmits="
              f"{rel.get('retransmits')} expired_peer_dead="
              f"{rel.get('expired_peer_dead')}")
    cluster.close()
    ctx.close()
    ok = (hung == 0 and counts["other"] == 0
          and (peer not in dead or counts["peer_dead"] > 0))
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="SPMD launcher: N OS-process ranks over a "
                    "cross-process transport backend")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="shm",
                    choices=("shm", "socket"))
    ap.add_argument("--attr", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="attr override exported as REPRO_ATTR_* to every "
                         "rank (repeatable)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="wall-clock bound; past it every rank is killed")
    ap.add_argument("--window", type=int, default=64,
                    help="demo: messages per completion window")
    ap.add_argument("--iters", type=int, default=50,
                    help="demo: windows per rank")
    ap.add_argument("--size", type=int, default=64,
                    help="demo: payload bytes")
    ap.add_argument("--device", default="cuda",
                    help="demo: the torch device each rank binds and "
                         "builds its payload on (default: the card; "
                         "'cpu' for the host)")
    ap.add_argument("--chaos-kill", type=int, default=None, metavar="RANK",
                    help="chaos demo: SIGKILL this rank once traffic "
                         "flows; survivors must detect it, drain every "
                         "outstanding post as ERR_PEER_DEAD and exit 0 "
                         "(the reference's elastic resharded restore "
                         "after the drain is not ported: it needs the "
                         "training stack)")
    ap.add_argument("--kill-after", type=float, default=1.0,
                    help="chaos demo: seconds between all-ranks-beating "
                         "and the SIGKILL")
    ap.add_argument("--hb-timeout", type=float, default=1.0,
                    help="chaos demo: heartbeat silence that declares a "
                         "rank dead")
    ap.add_argument("cmd", nargs="*",
                    help="rank program after `--` (default: built-in "
                         "message-window demo)")
    args = ap.parse_args(argv)

    if os.environ.get(RANK_ENV) is not None and not args.cmd:
        # child re-entry of a built-in demo
        if args.chaos_kill is not None:
            return _run_chaos_demo(args.size, args.chaos_kill,
                                   args.hb_timeout, args.device)
        return _run_demo(args.window, args.iters, args.size, args.device)

    overrides = {}
    for item in args.attr:
        name, eq, value = item.partition("=")
        if not eq:
            ap.error(f"--attr expects NAME=VALUE, got {item!r}")
        overrides[name] = value
    cmd = args.cmd or [sys.executable, "-m", "repro_torch.launch.spmd",
                       "--ranks", str(args.ranks),
                       "--window", str(args.window),
                       "--iters", str(args.iters),
                       "--size", str(args.size),
                       "--device", args.device]
    if args.chaos_kill is not None:
        if not args.cmd:
            cmd += ["--chaos-kill", str(args.chaos_kill),
                    "--hb-timeout", str(args.hb_timeout)]
            # survivors prove ERR_PEER_DEAD, not retry exhaustion: keep
            # unacked entries alive until the failure detector fires
            overrides.setdefault("reliability", "on")
            overrides.setdefault("retry_limit", "1000000")
            # inject-class sends never signal local comps (paper §3.2.5);
            # the demo counts send completions, so force bufcopy class
            overrides.setdefault("eager_max_bytes", "0")
        return launch(cmd, args.ranks, backend=args.backend,
                      attr_overrides=overrides, timeout=args.timeout,
                      kill_rank=args.chaos_kill,
                      kill_after=args.kill_after)
    return launch(cmd, args.ranks, backend=args.backend,
                  attr_overrides=overrides, timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
