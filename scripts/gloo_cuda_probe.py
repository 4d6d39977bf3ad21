"""Which collectives does this torch's gloo backend take on CUDA tensors?

    python scripts/gloo_cuda_probe.py           # on a card

Two ranks share the card (cuda:0) over gloo, as ``chip_smoke.py``'s
multi-rank phase runs them (NCCL refuses two ranks on one device).  Each
collective of ``distributed.shardmap_compat._collective`` and the
point-to-point exchange of ``ppermute`` is tried on CUDA tensors, fp32
and bf16, on a tensor at rest and on one a long matmul has just written
(the collective must order itself after the kernel), and its result
checked bitwise against the host's; a refusal is printed with its
message.  The answer sets
``shardmap_compat.GLOO_HOST_STAGED``.  Prints one JSON line, then the
card's name and power limit.  Needs CUDA; exits 1 without it.
"""
import json
import os
import subprocess
import sys
import tempfile


def rank_main(rank: int, store: str, out: str, which: str) -> None:
    import torch
    import torch.distributed as dist
    import datetime
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    x = torch.arange(4, dtype=torch.float32, device="cuda") + rank

    def fresh(dtype):
        """A tensor a long matmul has just written on the current stream
        (not synchronized: the collective must order itself after it),
        and its value on the host."""
        a = torch.full((4096, 4096), 1.0 / 64, device="cuda", dtype=dtype)
        y = (a @ a)[0, :4] * 0 + x.to(dtype)
        for _ in range(8):
            y = y + (a @ a)[0, :4] * 0
        return y

    def check(got, want):
        return bool(torch.equal(got.float().cpu(), torch.tensor(want)))

    def all_reduce(dtype, is_fresh):
        y = fresh(dtype) if is_fresh else x.to(dtype).clone()
        dist.all_reduce(y)
        return check(y, [1.0, 3.0, 5.0, 7.0])

    def all_gather(dtype, is_fresh):
        y = torch.empty(8, device="cuda", dtype=dtype)
        dist.all_gather_into_tensor(y, fresh(dtype) if is_fresh
                                    else x.to(dtype))
        return check(y, [0.0, 1.0, 2.0, 3.0, 1.0, 2.0, 3.0, 4.0])

    def reduce_scatter(dtype, is_fresh):
        y = torch.empty(2, device="cuda", dtype=dtype)
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(y, fresh(dtype) if is_fresh else x.to(dtype))
        return check(y, [1.0, 3.0] if rank == 0 else [5.0, 7.0])

    def batch_isend_irecv(dtype, is_fresh):
        y = torch.empty(4, device="cuda", dtype=dtype)
        src = fresh(dtype) if is_fresh else x.to(dtype)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, 1 - rank),
                dist.P2POp(dist.irecv, y, 1 - rank)]):
            w.wait()
        return check(y, (torch.arange(4.0) + 1 - rank).tolist())

    def barrier(dtype, is_fresh):
        dist.barrier()
        return True
    tries = dict(all_reduce=all_reduce, all_gather=all_gather,
                 reduce_scatter=reduce_scatter,
                 batch_isend_irecv=batch_isend_irecv, barrier=barrier)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for is_fresh in (False, True):
            key = f"{str(dtype)[6:]}{'/fresh' if is_fresh else ''}"
            try:
                res[key] = {"ok": True, "right": tries[which](dtype,
                                                              is_fresh)}
            except Exception as e:            # the refusal is the finding
                res[key] = {"ok": False, "error": repr(e)[:200]}
                break
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: CUDA is not available", file=sys.stderr)
        return 1
    found = {}
    for which in ("all_reduce", "all_gather", "reduce_scatter",
                  "batch_isend_irecv", "barrier"):
        # each collective in a pair of processes of its own: gloo may
        # abort a process (a fatal check) rather than raise
        tmp = tempfile.mkdtemp()
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "o.json")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             store, out, which], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
        if os.path.exists(out):
            with open(out) as f:
                found[which] = json.load(f)
        else:
            found[which] = {"ok": False, "exit": [p.returncode
                                                  for p in procs],
                            "log": logs[0][-300:]}
    print(json.dumps({"torch": torch.__version__, "gloo_on_cuda": found}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
