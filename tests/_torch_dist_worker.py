"""One rank of ``tests/test_torch_dist.py``'s 2-rank gloo group on the CPU.

    python tests/_torch_dist_worker.py <rank> <world> <init_method> <cases.pt> <out_dir>

It joins the group (``dist/mesh.init_group``), runs every case of
``cases.pt`` collectively and writes its results to ``<out_dir>/rank<r>.pt``:
the factor-sharded LM on the padded small problem and on the
cluster-partitioned one, the edge-sharded essential graph, a trial made
non-finite (which the distributed twin must reject, as the local solve
does), and ``run_local_ba`` / ``run_global_ba`` on a real map, which must take
the distributed path (``TPUSLAM_FORCE_LOCAL_BA`` is cleared here).  Nothing
of JAX is imported.
"""

import os
import sys

os.environ.pop("TPUSLAM_FORCE_LOCAL_BA", None)  # the distributed path is what this tests

import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuslam_torch.backend import local_ba  # noqa: E402
from tpuslam_torch.dist import ba as dba, mesh  # noqa: E402
from tpuslam_torch.graph import lm  # noqa: E402
from tpuslam_torch.map import mapstate as ms  # noqa: E402


def nonfinite_trial(state, data, w):
    """One distributed iteration whose step makes the first pose NaN."""
    solve = lm.schur_solve

    def poisoned(*a):
        dc, dl = solve(*a)
        return torch.cat([torch.full_like(dc[:6], float("nan")), dc[6:]]), dl

    lm.schur_solve = poisoned
    try:
        return dba.distributed_lm_iterations(state, data, w, 1)
    finally:
        lm.schur_solve = solve


def main():
    rank, world, init, cases_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh.init_group(init, world, rank, "cpu", timeout_s=120)
    c = torch.load(cases_path, weights_only=False)
    res = {"rank": mesh.rank(), "world": mesh.world_size()}

    state, data, w = c["lm"]
    res["lm"] = dba.distributed_lm_iterations(state, dba.pad_factors_for_mesh(data, world), w, 3)
    state, data, w = c["clustered"]
    res["clustered"] = dba.distributed_lm_iterations(state, data, w, 3)
    S0, fixed, edges = c["essential_graph"]
    res["essential_graph"] = dba.distributed_essential_graph(S0, fixed, dba.pad_edges_for_mesh(edges, world),
                                                             n_iters=10)
    state, data, w = c["lm"]
    res["nonfinite"] = nonfinite_trial(state, dba.pad_factors_for_mesh(data, world), w)

    fields, cam, cfg, center, n_kf = c["map"]
    m = ms.map_from_numpy(fields, "cpu")
    res["uses_distributed"] = local_ba.use_distributed_ba(cfg)
    calls = dba.ALLREDUCE["calls"]
    m_l, chi2_l = local_ba.run_local_ba(m, center, cam, cfg)
    res["local_ba"] = (m_l.kf_pose, m_l.pt_pos, m_l.kf_pt, chi2_l, dba.ALLREDUCE["calls"] - calls)
    calls = dba.ALLREDUCE["calls"]
    polls = []
    m_g, chi2_g = local_ba.run_global_ba(m, cam, cfg, n_iters=5, n_kf=n_kf, chunk=2,
                                         should_abort=lambda: polls.append(1) or True)
    res["global_ba"] = (m_g.kf_pose, m_g.pt_pos, chi2_g, dba.ALLREDUCE["calls"] - calls, len(polls))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
