"""Which gloo operations take CUDA tensors, on the card.

    python3 tools/gloo_cuda_probe.py

Two processes on cuda:0 join a gloo group and try, each in a fresh pair,
all_reduce, all_gather, broadcast and send/recv of a CUDA tensor; it prints
each rank's outcome (the error where one raises) and the card's name and
power limit. ``parallel/pp.py`` stages its hand-offs through host memory
for a gloo group holding CUDA tensors because of what this shows.
"""

import json
import os
import socket
import subprocess
import sys
import time

OPS = ("all_reduce", "all_gather", "broadcast", "send_recv")


def worker(rank: int, port: int, op: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    x = torch.full((1000,), float(rank + 1), device="cuda")
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif op == "all_gather":
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        ok = float(out[1][0]) == 2.0 and out[0].is_cuda
    elif op == "broadcast":
        dist.broadcast(x, 1)
        ok = float(x[0]) == 2.0
    elif rank == 0:
        dist.send(x, 1)
        ok = True
    else:
        y = torch.zeros_like(x)
        dist.recv(y, 0)
        ok = float(y[0]) == 1.0 and float(y[-1]) == 1.0
    torch.cuda.synchronize()
    print(json.dumps({"rank": rank, "op": op, "ok": ok}), flush=True)
    dist.destroy_process_group()


def main() -> None:
    import torch

    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), op],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for p in procs:
            try:
                out = p.communicate(timeout=90)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\nTIMEOUT"
            print(op, "rc", p.returncode, out.strip().splitlines()[-1][-300:], flush=True)
        print(op, "seconds", round(time.time() - t0, 1), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        main()
