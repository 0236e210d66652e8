"""Host-clock ms of the public `solve_full_chain_ik` (layer `ik`) on the
cell's ground-truth Joint2, Joint4 and Joint6 marker points and base, at the
engine's own iterations and restarts, ending in a synchronise: the median
of `probe_reps` calls after one warm call."""


def read(run):
    import torch

    from benchmark.lib.arm import MARKER_LINKS
    from benchmark.lib.trace import host_ms
    from mamri_tpu_torch.ik.residuals import solve_full_chain_ik

    eng, scene = run.engine, run.data["scenes"][0]
    dev, f32 = eng.device, torch.float32
    pts = torch.as_tensor(scene.markers.reshape(len(MARKER_LINKS), 3, 3), dtype=f32, device=dev)
    base = torch.as_tensor(scene.base, dtype=f32, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)

    def solve():
        return solve_full_chain_ik(eng.model, pts[3], base, joint4_targets=pts[2], joint4_found=yes,
                                   num_iters=eng.ik_iters, num_random_restarts=eng.ik_restarts,
                                   joint2_targets=pts[1], joint2_found=yes)

    return host_ms(solve, run.cell.params["probe_reps"], run.sync)
