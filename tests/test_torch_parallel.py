"""The port's parallel layers (orb_slam3_tpu_torch/parallel) on CPU
processes over torch.distributed's gloo backend.

- shard_ba_problem equals the JAX package's arrays exactly (on
  tests/test_dist_ba.py's problem shapes, drawn with numpy);
- the landmark-sharded global BA at a world of one gives the same bits as
  mapping/global_ba.global_ba (buckets of 1; with the default buckets,
  poses within 5e-3 and points within 2e-2, as on the card);
- one launch of four gloo processes: init_distributed and an all-reduce
  (the twin of tests/test_multihost.py::test_jax_distributed_two_process),
  dist_ba_solve on tests/test_dist_ba.py's problem sharded over the four
  against the port's one-process solve, the two-level (2 hosts x 2) global
  BA of a tracked map against the flat one (tests/test_multihost.py's
  tolerances), and the fleet step with its sessions split over the ranks
  against the world of one;
- HostedAtlas.ship_map: every row arrives, the sender's rows go;
- behind `slow`: a two-process launch (init_distributed, an all-reduce,
  the solve over two shards) against the JAX dist_ba_solve on
  the 8-device CPU mesh (poses 5e-3, points 2e-2, final cost < 5% of the
  first), distributed_global_ba against the JAX function on a converted
  tracked map, and tests/test_multihost.py's cross-host merge session.

Child processes import only the port; the JAX side runs in the parent.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))

from orb_slam3_tpu_torch import convert, entry
from orb_slam3_tpu_torch.atlas import invariants as tinv
from orb_slam3_tpu_torch.atlas import ops as tops
from orb_slam3_tpu_torch.frontend import orb as torb
from orb_slam3_tpu_torch.mapping import global_ba as tgba
from orb_slam3_tpu_torch.parallel import dist_ba as tdist
from orb_slam3_tpu_torch.parallel import map_ba as tmap_ba
from orb_slam3_tpu_torch.parallel import multihost as tmh
from orb_slam3_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_NP = np.asarray([200.0, 200.0, 128.0, 96.0, 0, 0, 0, 0], np.float32)
WH = (256, 192)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(prog: str, n: int, *args, timeout=60):
    """Run `prog` in n processes (argv: rank, world, port, *args); every one
    must exit 0. Returns their outputs."""
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(prog), str(r), str(n),
                               port, *map(str, args)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


@pytest.fixture
def world_of_one():
    """An in-process gloo group of one rank."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the BA problem of tests/test_dist_ba.py, as numpy
# ---------------------------------------------------------------------------

def dist_problem():
    """tests/test_dist_ba.py's scene (5 cameras, 160 points, the first two
    cameras fixed) from the JAX package's generator, as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from orb_slam3_tpu.ops import lie
    from test_lm_schur import build_ba_problem, multi_view_scene

    X, R, t, uv = multi_view_scene(jax.random.PRNGKey(0), n_cams=5, n_pts=160, noise_px=0.3)
    X0 = X + 0.08 * jax.random.normal(jax.random.PRNGKey(1), X.shape)
    dxi = 0.02 * jax.random.normal(jax.random.PRNGKey(2), (5, 6))
    dxi = dxi.at[0].set(0.0).at[1].set(0.0)
    dR, dt = lie.se3_exp(dxi)
    R0, t0 = lie.se3_mul(dR, dt, R, t)
    fixed = jnp.zeros(5, bool).at[0].set(True).at[1].set(True)
    bap = build_ba_problem(R0, t0, X0, uv, fixed)
    from test_lm_schur import K

    return dict(R0=np.asarray(R0), t0=np.asarray(t0), X0=np.asarray(X0),
                fixed=np.asarray(fixed), cam_idx=np.asarray(bap.cam_idx),
                lm_idx=np.asarray(bap.lm_idx), uv=np.asarray(bap.obs_data["uv"]),
                info=np.asarray(bap.obs_info), mask=np.asarray(bap.obs_mask),
                K=np.asarray(K, np.float32))


def np_problem(n_cams=5, n_pts=160, noise_px=0.3, seed=0):
    """The same scene drawn with numpy (the port's own SE3 exp): cameras on
    an arc looking at a landmark cloud, full visibility, landmarks moved by
    0.08 and the cameras after the first two by 0.02 in the tangent."""
    from orb_slam3_tpu_torch.ops import lie as tlie

    rng = np.random.default_rng(seed)
    K = np.asarray([450.0, 450.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)
    X = np.concatenate([rng.uniform(-3, 3, (n_pts, 2)), rng.uniform(6, 12, (n_pts, 1))], -1)
    xi = np.asarray([[0.4 * i, 0.02 * i, 0.01 * i, 0.0, 0.05 * i, 0.0] for i in range(n_cams)])
    R, t = (a.numpy().astype(np.float64) for a in tlie.se3_exp(torch.from_numpy(xi)))
    Xc = np.einsum("cij,pj->cpi", R, X) + t[:, None]
    uv = Xc[..., :2] / Xc[..., 2:] * K[:2] + K[2:4] + rng.normal(0, noise_px, (n_cams, n_pts, 2))
    dxi = 0.02 * rng.normal(size=(n_cams, 6))
    dxi[:2] = 0.0
    dR, dt = (a.numpy().astype(np.float64) for a in tlie.se3_exp(torch.from_numpy(dxi)))
    R0 = dR @ R
    t0 = np.einsum("cij,cj->ci", dR, t) + dt
    E = n_cams * n_pts
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(R0=f32(R0), t0=f32(t0), X0=f32(X + 0.08 * rng.normal(size=X.shape)),
                fixed=np.arange(n_cams) < 2,
                cam_idx=np.repeat(np.arange(n_cams, dtype=np.int32), n_pts),
                lm_idx=np.tile(np.arange(n_pts, dtype=np.int32), n_cams),
                uv=f32(uv.reshape(E, 2)), info=np.ones(E, np.float32), mask=np.ones(E, bool),
                K=K)


@pytest.fixture(scope="module")
def problem():
    """Tier-1's BA problem: tests/test_dist_ba.py's shapes drawn with numpy."""
    return np_problem()


@pytest.fixture(scope="module")
def jax_problem():
    """tests/test_dist_ba.py's own problem, drawn by the JAX package."""
    return dist_problem()


def port_solve(pb, n_dev, reduce=None):
    from orb_slam3_tpu_torch.lm import edges

    sh = tdist.shard_ba_problem(n_dev, pb["X0"], np.zeros(len(pb["X0"]), bool), pb["cam_idx"],
                                pb["lm_idx"], pb["uv"], pb["info"], pb["mask"])
    res = edges.make_mono_residual(0)
    cams, pts, costs = tdist.dist_ba_solve(
        lambda c, x, d: res(c, {"x": x}, d), edges.se3_retract,
        {"R": torch.from_numpy(pb["R0"]), "t": torch.from_numpy(pb["t0"])}, pb["fixed"],
        pb["K"], *sh, num_iters=10, lam0=1e-6, reduce=reduce, device="cpu")
    return cams, pts.reshape(-1, 3)[:len(pb["X0"])].numpy(), costs


def test_shard_ba_problem_equals_the_jax_layout(problem):
    from orb_slam3_tpu.parallel import dist_ba as jdist

    pb = problem
    rng = np.random.default_rng(0)
    mask = pb["mask"] & (rng.random(len(pb["mask"])) > 0.1)  # a few masked edges
    pfix = rng.random(len(pb["X0"])) > 0.9
    for n_dev, bucket in ((1, 1), (3, 1), (8, 1), (8, 64)):
        want = jdist.shard_ba_problem(n_dev, pb["X0"], pfix, pb["cam_idx"], pb["lm_idx"],
                                      pb["uv"], pb["info"], mask, edge_bucket=bucket)
        got = tdist.shard_ba_problem(n_dev, pb["X0"], pfix, pb["cam_idx"], pb["lm_idx"],
                                     pb["uv"], pb["info"], mask, edge_bucket=bucket)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and w.shape == g.shape
            np.testing.assert_array_equal(w, g)


# ---------------------------------------------------------------------------
# a small tracked map (the port at the small CPU config)
# ---------------------------------------------------------------------------

def tracked_map(n=8, seed=4):
    """A port RGB-D session at 256x192 over tests/test_map_ba.py's orbit."""
    cfg = ttrk.TrackerConfig(K=convert.camera(K_NP, "cpu"), img_wh=WH,
                             orb=torb.OrbConfig(300, 4), kmax=16, lmax=1024, local_window=4,
                             sensor="rgbd", bf=20.0, th_depth=20.0, async_mapping=False,
                             pipeline_depth=1)
    planes = entry.plane_scene(seed)
    R, t = entry.orbit_trajectory(n)
    tr = ttrk.Tracker(cfg, device="cpu")
    for i in range(n):
        img, depth = entry.render_with_depth(planes, tuple(K_NP[:4]), WH, R[i], t[i])
        tr.process(img, 0.05 * i, depth_map=depth)
    tr.shutdown()
    assert tr.state == ttrk.OK and int(tr.map.kf_valid.sum()) >= 3
    return tr.map, R, t


@pytest.fixture(scope="module")
def small_map():
    return tracked_map()


def test_world_of_one_is_global_ba_to_the_bit(small_map, world_of_one):
    s, _, _ = small_map
    want = tgba.global_ba(s, K_NP, num_iters=4)
    got = tmap_ba.distributed_global_ba(s, K_NP, num_iters=4, cam_bucket=1, edge_bucket=1,
                                        device="cpu")
    for name in ("kf_R", "kf_t", "lm_pos"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # the JAX package's buckets: padded cameras are fixed, padded edges masked
    got_b = tmap_ba.distributed_global_ba(s, K_NP, num_iters=4, device="cpu")
    kv, lv = s.kf_valid, s.lm_valid
    torch.testing.assert_close(got_b.kf_t[kv], want.kf_t[kv], rtol=0, atol=5e-3)
    torch.testing.assert_close(got_b.lm_pos[lv], want.lm_pos[lv], rtol=0, atol=2e-2)
    assert not tinv.check_all(got_b)


_TWO_RANKS = """
import sys
import numpy as np, torch
rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from orb_slam3_tpu_torch.parallel import multihost
multihost.init_distributed(coordinator="127.0.0.1:" + port, num_processes=world,
                           process_id=rank, device="cpu")
multihost.init_distributed(coordinator="127.0.0.1:" + port, num_processes=world,
                           process_id=rank, device="cpu")   # a no-op when initialised
import torch.distributed as dist
x = torch.full((1,), rank + 1.0)
dist.all_reduce(x)
assert float(x) == world * (world + 1) / 2, float(x)
sys.path.insert(0, "tests")
from test_torch_parallel import port_solve
pb = dict(np.load(path))
cams, pts, costs = port_solve(pb, world)
if rank == 0:
    np.savez(path + ".out.npz", R=cams["R"].numpy(), t=cams["t"].numpy(), pts=pts,
             costs=np.asarray(costs))
dist.destroy_process_group()
print("OK", rank)
"""


@pytest.fixture(scope="module")
def two_rank_solve(jax_problem, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "problem.npz")
    np.savez(path, **jax_problem)
    outs = run_ranks(_TWO_RANKS, 2, path)
    assert all(f"OK {r}" in o for r, o in enumerate(outs))
    return dict(np.load(path + ".out.npz"))


@pytest.mark.slow
def test_two_gloo_ranks_agree_with_the_jax_mesh(jax_problem, two_rank_solve):
    """tests/test_dist_ba.py's agreement: the port over two processes
    against the JAX dist_ba_solve on the 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from orb_slam3_tpu.lm import edges as jedges
    from orb_slam3_tpu.parallel import dist_ba as jdist

    pb = jax_problem
    sharded = jdist.shard_ba_problem(8, pb["X0"], np.zeros(len(pb["X0"]), bool), pb["cam_idx"],
                                     pb["lm_idx"], pb["uv"], pb["info"], pb["mask"])
    res = jedges.make_mono_residual(0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("lm",))
    cams, pts, costs = jdist.dist_ba_solve(
        mesh, lambda c, x, d: res(c, {"x": x}, d), jedges.se3_retract,
        {"R": jnp.asarray(pb["R0"]), "t": jnp.asarray(pb["t0"])}, jnp.asarray(pb["fixed"]),
        jnp.asarray(pb["K"]), *sharded, num_iters=10, lam0=1e-6)
    got = two_rank_solve
    assert got["costs"][-1] < got["costs"][0] * 0.05 and costs[-1] < costs[0] * 0.05
    np.testing.assert_allclose(got["t"], np.asarray(cams["t"]), atol=5e-3)
    np.testing.assert_allclose(got["R"], np.asarray(cams["R"]), atol=5e-3)
    flat = np.asarray(pts).reshape(-1, 3)[:len(pb["X0"])]
    np.testing.assert_allclose(got["pts"], flat, atol=2e-2)


_FOUR_RANKS = """
import sys
import numpy as np, torch
rank, world, port, prob, mp, fl = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
from orb_slam3_tpu_torch.atlas.state import MapState
from orb_slam3_tpu_torch.frontend import orb
from orb_slam3_tpu_torch.parallel import fleet, map_ba, multihost
multihost.init_distributed(coordinator="127.0.0.1:" + port, num_processes=world,
                           process_id=rank, device="cpu")
multihost.init_distributed(coordinator="127.0.0.1:" + port, num_processes=world,
                           process_id=rank, device="cpu")   # a no-op when initialised
import torch.distributed as dist
x = torch.full((1,), rank + 1.0)
dist.all_reduce(x)
assert float(x) == world * (world + 1) / 2, float(x)
out = {}
sys.path.insert(0, "tests")
from test_torch_parallel import port_solve
cams, pts, costs = port_solve(dict(np.load(prob)), world)
out.update(R=cams["R"].numpy(), t=cams["t"].numpy(), pts=pts, costs=np.asarray(costs))
d = np.load(mp)
s = MapState(**{k: torch.from_numpy(d[k]) for k in d.files if not k.startswith("__")})
K8 = d["__K"]
flat = map_ba.distributed_global_ba(s, K8, num_iters=6, device="cpu")
mesh = multihost.two_level_mesh(2, 2)
two, gcosts = multihost.dist_gba_two_level(s, K8, mesh, num_iters=6, device="cpu")
assert len(gcosts) == 6 and gcosts[-1] <= gcosts[0], gcosts
out.update(flat_R=flat.kf_R.numpy(), flat_t=flat.kf_t.numpy(), flat_X=flat.lm_pos.numpy(),
           two_R=two.kf_R.numpy(), two_t=two.kf_t.numpy(), two_X=two.lm_pos.numpy())
f = np.load(fl)
step = fleet.make_fleet_step(orb.OrbConfig(200, 2), f["K"], img_wh=(192, 128), device="cpu")
fR, ft, fn = step(*[f[f"a{i}"] for i in range(9)])
out.update(fleet_R=fR.numpy(), fleet_t=ft.numpy(), fleet_n=fn.numpy())
if rank == world - 1:
    np.savez(prob + ".out.npz", **out)
dist.destroy_process_group()
print("OK", rank)
"""


@pytest.fixture(scope="module")
def four_ranks(problem, small_map, tmp_path_factory):
    """One launch of four gloo processes: init_distributed (twice) and an
    all-reduce; dist_ba_solve on tests/test_dist_ba.py's problem over four
    shards; the flat and the two-level (2 hosts x 2) global BA of the small
    tracked map; the fleet step at B = 8 (2 sessions a rank)."""
    from test_torch_fleet import seeded_fleet_inputs, K_NP as K_FLEET

    d = tmp_path_factory.mktemp("ranks")
    prob, mp, fl = (str(d / n) for n in ("problem.npz", "map.npz", "fleet.npz"))
    np.savez(prob, **problem)
    np.savez(mp, __K=K_NP, **convert.map_state_arrays(small_map[0]))
    fleet_args = seeded_fleet_inputs()
    np.savez(fl, K=K_FLEET, **{f"a{i}": a for i, a in enumerate(fleet_args)})
    outs = run_ranks(_FOUR_RANKS, 4, prob, mp, fl)
    assert all(f"OK {r}" in o for r, o in enumerate(outs))
    return dict(np.load(prob + ".out.npz")), fleet_args, K_FLEET


def test_four_gloo_ranks_agree_with_one_process(problem, four_ranks):
    """The landmark-sharded solve over four processes against the port's
    solve in one (the same LM loop; the reduced system summed in another
    order)."""
    cams, pts, costs = port_solve(problem, 1)
    got = four_ranks[0]
    assert got["costs"][-1] < got["costs"][0] * 0.05
    np.testing.assert_allclose(got["R"], cams["R"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t"], cams["t"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["pts"], pts, rtol=0, atol=1e-3)


def test_two_level_gba_equals_flat_over_four_ranks(small_map, four_ranks):
    """tests/test_multihost.py::test_two_level_gba_matches_flat: 2 hosts x 2
    ranks, the reduction staged within the host, across the host leaders
    and back, against the flat group."""
    s, _, _ = small_map
    r = four_ranks[0]
    kv, lv = s.kf_valid.numpy(), s.lm_valid.numpy()
    np.testing.assert_allclose(r["two_R"][kv], r["flat_R"][kv], rtol=0, atol=2e-4)
    np.testing.assert_allclose(r["two_t"][kv], r["flat_t"][kv], rtol=0, atol=2e-4)
    np.testing.assert_allclose(r["two_X"][lv], r["flat_X"][lv], rtol=0, atol=5e-4)
    # and the flat group of four against the one-card global BA
    want = tgba.global_ba(s, K_NP, num_iters=6)
    np.testing.assert_allclose(r["flat_t"][kv], want.kf_t.numpy()[kv], rtol=0, atol=2e-4)


def test_fleet_over_four_ranks_equals_one_process(four_ranks):
    """The fleet's 8 sessions split over four ranks (2 each, K2 once a rank)
    and gathered: the world of one's results."""
    from orb_slam3_tpu_torch.parallel import fleet

    got, args, K = four_ranks
    step = fleet.make_fleet_step(torb.OrbConfig(200, 2), K, img_wh=(192, 128), device="cpu")
    R, t, n = step(*args)
    np.testing.assert_array_equal(got["fleet_n"], n.numpy())
    np.testing.assert_allclose(got["fleet_R"], R.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["fleet_t"], t.numpy(), rtol=0, atol=1e-5)


def test_distributed_entry_points_raise_without_a_group():
    s = ttrk.empty_map(ttrk.TrackerConfig(K=K_NP, img_wh=WH, kmax=4, lmax=32), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmap_ba.distributed_global_ba(s, K_NP, device="cpu")


@pytest.mark.slow
def test_distributed_gba_agrees_with_jax_on_a_tracked_map(small_map, world_of_one):
    """tests/test_map_ba.py's call on a converted tracked map: the JAX
    distributed_global_ba on the 8-device mesh against the port's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from orb_slam3_tpu.atlas import state as jstate
    from orb_slam3_tpu.parallel import map_ba as jmap_ba

    s, _, _ = small_map
    js = jstate.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_arrays(s).items()})
    mesh = Mesh(np.array(jax.devices()[:8]), ("lm",))
    want = jmap_ba.distributed_global_ba(js, jnp.asarray(K_NP), mesh, num_iters=6)
    got = tmap_ba.distributed_global_ba(s, K_NP, num_iters=6, device="cpu")
    kv, lv = s.kf_valid.numpy(), s.lm_valid.numpy()
    np.testing.assert_allclose(got.kf_R.numpy()[kv], np.asarray(want.kf_R)[kv], atol=5e-3)
    np.testing.assert_allclose(got.kf_t.numpy()[kv], np.asarray(want.kf_t)[kv], atol=5e-3)
    np.testing.assert_allclose(got.lm_pos.numpy()[lv], np.asarray(want.lm_pos)[lv], atol=2e-2)


# ---------------------------------------------------------------------------
# HostedAtlas
# ---------------------------------------------------------------------------

def test_ship_map_moves_every_row(small_map):
    """ship_map appends map 1's keyframes and landmarks to the other host's
    arena (growing it), keeps the receiver's active map, and invalidates
    the sender's rows; the receiver stays consistent."""
    s, _, _ = small_map
    sA = tops.change_map_id(s, 0, 1)
    sB = s  # the same map, under id 0, on the other host
    ha = tmh.HostedAtlas.create(2, [sA, sB])
    assert ha.host_of_map == {1: 0, 0: 1}
    kf_a, lm_a = int(sA.kf_valid.sum()), int(sA.lm_valid.sum())
    kf_b, lm_b = int(sB.kf_valid.sum()), int(sB.lm_valid.sum())
    ha.ship_map(1, to_host=1)
    dst = ha.host_maps[1]
    assert ha.host_of_map[1] == 1 and int(dst.n_kf) == int(sB.n_kf) + kf_a
    kv, lv = dst.kf_valid.numpy(), dst.lm_valid.numpy()
    assert int((dst.kf_map_id.numpy()[kv] == 1).sum()) == kf_a
    assert int((dst.kf_map_id.numpy()[kv] == 0).sum()) == kf_b
    assert int((dst.lm_map_id.numpy()[lv] == 1).sum()) == lm_a
    assert int((dst.lm_map_id.numpy()[lv] == 0).sum()) == lm_b
    assert int(dst.active_map) == 0 and int(dst.n_maps) == 2
    assert int(ha.host_maps[0].kf_valid.sum()) == 0 and int(ha.host_maps[0].lm_valid.sum()) == 0
    # the shipped keyframes see the shipped landmarks at their old positions
    rows = np.flatnonzero(kv & (dst.kf_map_id.numpy() == 1))
    fl = dst.kf_feat_lm.numpy()[rows]
    assert (dst.lm_map_id.numpy()[fl[fl >= 0]] == 1).all()
    np.testing.assert_array_equal(
        np.sort(dst.lm_pos.numpy()[lv & (dst.lm_map_id.numpy() == 1)], axis=0),
        np.sort(sA.lm_pos.numpy()[sA.lm_valid.numpy()], axis=0))
    assert not tinv.check_all(dst)


@pytest.mark.slow
def test_hosted_atlas_cross_host_merge():
    """tests/test_multihost.py::test_hosted_atlas_cross_host_merge on the
    port at its size: two sessions map disjoint halves of one orbit; host
    0's map ships into host 1's arena, host 1 adopts it and revisits host
    0's region, and the maps merge into one."""
    from orb_slam3_tpu_torch.api import evaluate as teval

    K = (350.0, 350.0, 256.0, 192.0)
    wh = (512, 384)
    planes = entry.plane_scene(7)
    R_gt, t_gt = entry.orbit_trajectory(40, advance=0.05)

    def session():
        cfg = entry.tracker_config("cpu", img_wh=wh, K=K, sensor="rgbd", bf=35.0,
                                   th_depth=20.0, orb=torb.OrbConfig(600, 4), kmax=96,
                                   lmax=12288, local_window=6, kf_max_frames=2,
                                   deterministic_mapping=True)
        return ttrk.Tracker(cfg, device="cpu"), cfg

    frame = lambda i: entry.render_with_depth(planes, K, wh, R_gt[i], t_gt[i])  # noqa: E731
    tA, cfg = session()
    voc = entry.train_vocabulary([frame(i)[0] for i in range(3)], cfg)
    tA.attach_loop_closer(voc)
    for i in range(20):
        img, depth = frame(i)
        tA.process(img, i * 0.05, depth_map=depth)
    tA.settle()
    assert tA.state == ttrk.OK and int(tA.map.n_kf) >= 6
    tB, _ = session()
    tB.attach_loop_closer(voc)
    for k, i in enumerate(range(22, 40)):
        img, depth = frame(i)
        tB.process(img, 50.0 + k * 0.05, depth_map=depth)
    tB.settle()
    assert tB.state == ttrk.OK and int(tB.map.n_kf) >= 6
    tA.sync_mapping()
    sA = tops.change_map_id(tA.map, 0, 1)
    ha = tmh.HostedAtlas.create(2, [sA, tB.map])
    kf_a = int(sA.kf_valid.sum())
    ha.ship_map(1, to_host=1)
    dst = ha.host_maps[1]
    assert int((dst.kf_map_id[dst.kf_valid] == 1).sum()) == kf_a
    tB.adopt_map(dst)
    merged = False
    for k, i in enumerate(range(18, 2, -2)):
        img, depth = frame(i)
        tB.process(img, 60.0 + k * 0.05, depth_map=depth)
        tB.sync_mapping()
        if tB.loop_closer.n_merges > 0:
            merged = True
            break
    tA.shutdown()
    tB.shutdown()
    assert merged, "cross-host shipped map never merged"
    s = tB.map
    kv = s.kf_valid.numpy()
    assert len(np.unique(s.kf_map_id.numpy()[kv])) == 1
    kc = teval.camera_centers(s.kf_R.numpy()[kv], s.kf_t.numpy()[kv])
    kts = s.kf_timestamp.numpy()[kv]
    early = kts < 1.01
    fr = np.where(early, (kts / 0.05 + 0.5).astype(int),
                  np.where(kts < 59.0, ((kts - 50.0) / 0.05 + 0.5).astype(int) + 22,
                           18 - 2 * ((kts - 60.0) / 0.05 + 0.5).astype(int)))
    gtc = teval.camera_centers(R_gt[fr], t_gt[fr])
    _, _, _, err = teval.horn_align(kc.T, gtc.T, with_scale=False)
    assert float(np.sqrt(np.mean(err ** 2))) < 0.15
    assert err[early].max() < 0.25
