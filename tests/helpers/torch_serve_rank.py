"""One rank of the port's two-process serving run (started by
``repro_torch.launch.spmd``): rank 0 is the ``TokenClient``, rank 1 the
``ContinuousBatcher``, over the launcher's transport, on the CPU.

    python tests/helpers/torch_serve_rank.py OUTDIR   # under the launcher

The client submits a seeded schedule (numpy prompts, explicit rids),
drains every expected token, then sends the end-of-traffic message; the
server serves until it has seen that message and nothing is resident.
Each rank writes ``OUTDIR/rank<r>.json``: the client its ``collect()``
report and every stream it received, the server its counters.  Imports
only the port.
"""
import json
import os
import sys
import time

import numpy as np

from repro_torch.core import ProcessCluster
from repro_torch.launch.spmd import bootstrap
from repro_torch.serving import (ContinuousBatcher, ServePlane,
                                 SyntheticModel, TokenClient,
                                 decode_token_row)

SEED = 3
N_REQUESTS = 12
DEADLINE_S = 60.0


def main(outdir: str) -> int:
    ctx = bootstrap()
    cl = ProcessCluster(ctx.n_ranks, ctx.rank, fabric_depth=1 << 12,
                        session=os.path.join(ctx.session, "serve"),
                        device="cpu")
    plane = ServePlane(cl, client_rank=0, server_rank=1)
    model = SyntheticModel(seed=SEED, device="cpu")
    ctx.barrier(timeout=60)
    deadline = time.monotonic() + DEADLINE_S
    ok = True
    if ctx.rank == 1:
        server = ContinuousBatcher(plane, model, kv_slots=4,
                                   kv_page_tokens=8, prefill_chunk=8)
        while not (server.eot_seen and server.idle):
            server.step()
            if time.monotonic() > deadline:
                ok = False
                break
        out = {"role": "server", "ok": ok, "counters": server.counters()}
    else:
        client = TokenClient(plane, model, drain_workers=2)
        rng = np.random.default_rng(SEED)
        for rid in range(1, N_REQUESTS + 1):
            prompt = rng.integers(0, 1000, int(rng.integers(1, 40))
                                  ).astype(np.int32)
            max_new = int(rng.integers(1, 10))
            _, st = client.submit(prompt, max_new, rid=rid)
            while st.is_retry() and time.monotonic() < deadline:
                client.pump()
                _, st = client.submit(prompt, max_new, rid=rid)
            client.pump()
        while client.drain.drained < client.expected_tokens:
            client.pump()
            if time.monotonic() > deadline:
                ok = False
                break
        client.send_eot()
        for _ in range(200):                     # flush the EOT
            client.pump()
        report = client.collect()
        got = {}
        for chunk in client.drain.worker_results():
            for st, _t in chunk:
                rid, seq, tok, _done = decode_token_row(st.get_buffer())
                got.setdefault(rid, []).append((seq, tok))
        streams = {rid: (plen, max_new,
                         [tok for _, tok in sorted(got.get(rid, []))])
                   for rid, (_t, plen, max_new) in client.records.items()}
        out = {"role": "client", "ok": ok, "seed": SEED,
               "n_requests": N_REQUESTS,
               "report": {k: v for k, v in report.items()
                          if k not in ("ttft_s", "gap_s")},
               "streams": streams}
    with open(os.path.join(outdir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(out, f)
    ctx.barrier(timeout=60)
    cl.close()
    ctx.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
