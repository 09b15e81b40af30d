"""One rank of the four-card traffic at a tiny size on the CPU (gloo), for
the tests: ``python -m portbench.tests.ranks_worker RANK RENDEZVOUS_FILE FAULT``.
Rank 0 prints the run's result as JSON. FAULT ``exchange`` leaves out the
exchange between the ranks (``parallel/mesh.py::all_reduce_sum`` does
nothing); ``none`` runs the program as it is."""

import json
import sys
import time
import types

import torch


def main() -> None:
    rank, rdv, fault = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from portbench.drivers import fit_decoder
    from portbench.tests.test_portbench_faults import tiny
    from reni_tpu_torch.parallel import mesh as meshlib
    from reni_tpu_torch.parallel import multihost

    multihost.initialize(device="cpu", init_method=f"file://{rdv}")
    if fault == "exchange":
        meshlib.all_reduce_sum = lambda tensors, group: None
    cell = tiny("reni_cbc_5x256.fit_decoder", "fit_decoder_dp4")
    ctx = types.SimpleNamespace(cell=cell, seed=2**33 + 11,
                                seconds=0.3, trace=0, device=torch.device("cpu"),
                                t_start=time.time(), rank=rank, world=4)
    result = fit_decoder.run(ctx)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(result))


if __name__ == "__main__":
    main()
