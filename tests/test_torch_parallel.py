"""The port's parallel layer on the CPU against the JAX package: the mesh,
``pipeline_step`` and ``make_example_inputs``, the sharded sort, the
repaired ``align_and_sort(mesh=...)`` and the dry-run.

Meshes of more than one rank run as gloo processes spawned by
``parallel/dryrun.run_ranks`` (each with a time limit, killed when it runs
out); the spawns are shared: one world of 4 ranks runs the 2 x 2 step and
the sorts at p = 2 and 4, one of 8 the 4 x 2 step and the sort at p = 8.
The JAX package runs the same mesh shapes over its virtual CPU devices
(``tests/conftest.py`` gives 16), by its ``impl="xla"`` path.

Tolerances: the port's likelihoods equal the JAX package's within rtol
1e-6, the JAX package's own parity bound (``tests/test_parallel.py:68``),
not bit for bit: XLA:CPU contracts a*b+c into FMA, while the port's plain
forward rounds every op, as its kernel does with ``--fmad=false``
(``tests/test_torch_pairhmm.py:test_plain_f32_vs_xla_spec``).  Everything
else is exact: SW scores, the sort, and every port-to-port comparison
(sharded against one rank).

The JAX package is imported inside the tests that use it, so
``python -m pytest tests/test_torch_parallel.py -m cuda`` runs the card's
test on a host without jax.
"""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.parallel import sort as S
from mgl_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
from mgl_tpu_torch.parallel.mesh import Mesh, all_gather, make_mesh
from mgl_tpu_torch.parallel.pipeline import (make_example_inputs,
                                             pipeline_step)
from mgl_tpu_torch.parallel.sort import join_u64
from mgl_tpu_torch.testing import (align_sort_rank, mesh_suite,
                                   sort_keys_full_range)

torch.set_num_threads(1)
BASES = np.frombuffer(b"ACGT", np.uint8)
LIK_RTOL = 1e-6
# (n_dp, n_hp, seed, make_example_inputs kwargs) of the spawned steps:
# tests/test_parallel.py's 2 x 2 (seed 11) and 4 x 2 (seed 7, whose reads
# include negative best SW scores) cases
MESH_CASES = {4: (2, 2, 11, {"r_per_dev": 4, "h_per_dev": 2}),
              8: (4, 2, 7, {})}
SORT_N = 1000


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _sort_shapes(world):
    """(n_dp, n_hp, keys) of each sort a world runs: p = 2 and 4 on 4
    ranks, p = 8 on 8."""
    dps = {4: (2, 4), 8: (8,)}[world]
    return [(p, world // p, sort_keys_full_range(p, SORT_N + 37 * p))
            for p in dps]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run the shared spawns once: {world: output directory}."""
    out = {}
    for world, case in MESH_CASES.items():
        d = tmp_path_factory.mktemp(f"world{world}")
        run_ranks(mesh_suite, world, "cpu", ([case], _sort_shapes(world),
                                             str(d)), timeout=180)
        out[world] = d
    return out


def jax_mesh(n_dp, n_hp):
    """The JAX package's mesh over its first n_dp * n_hp CPU devices."""
    import jax
    from mgl_tpu.parallel.mesh import make_mesh

    return make_mesh(n_dp, n_hp, devices=jax.devices("cpu")[:n_dp * n_hp])


def _jax_step(n_dp, n_hp, seed, kw):
    """The JAX package's step, under jax.jit (eager, its lax.scan path
    takes ~5 s a call on the CPU; jitted ~0.5 s)."""
    import jax
    from mgl_tpu.parallel import pipeline as JP

    mesh = jax_mesh(n_dp, n_hp)
    args = JP.make_example_inputs(mesh, seed=seed, **kw)
    step = jax.jit(JP.pipeline_step(mesh, impl="xla"))
    return {k: np.asarray(v) for k, v in step(*args).items()}


def _keys(out):
    return join_u64(np.asarray(out["sorted_key_hi"]),
                    np.asarray(out["sorted_key_lo"]))


def _held_to_jax(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["likelihoods"], want["likelihoods"],
                               rtol=LIK_RTOL, atol=0)
    np.testing.assert_allclose(got["best_hap_lik"], want["best_hap_lik"],
                               rtol=LIK_RTOL, atol=0)
    np.testing.assert_array_equal(got["sw_scores"], want["sw_scores"])
    np.testing.assert_array_equal(_keys(got), _keys(want))
    # the example keys are distinct 62-bit draws, so the order is defined
    # even though lax.sort is not stable
    assert len(np.unique(_keys(want))) == len(_keys(want))
    np.testing.assert_array_equal(got["sorted_order"], want["sorted_order"])


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_make_example_inputs_equal_jax(seed):
    """The global host arrays equal the JAX package's byte for byte (dtype,
    shape, bytes) on a 1 x 1 and a 2 x 2 mesh shape, and each rank's shard
    is its block of them."""
    from mgl_tpu.parallel import pipeline as JP

    for n_dp, n_hp in ((1, 1), (2, 2)):
        want = JP.make_example_inputs(jax_mesh(n_dp, n_hp), seed=seed)
        for rank in range(n_dp * n_hp):
            mesh = Mesh(n_dp, n_hp, rank, torch.device("cpu"),
                        {"dp": None, "hp": None})
            full, local = make_example_inputs(mesh, seed=seed)
            for g, w in zip(full, want):
                assert g.keys() == w.keys()
                for k in g:
                    a, b = g[k], np.asarray(w[k])
                    assert (a.dtype, a.shape) == (b.dtype, b.shape), k
                    assert a.tobytes() == b.tobytes(), k
            d, h = rank // n_hp, rank % n_hp
            for part, axis, block in ((0, "dp", d), (1, "hp", h)):
                for k, v in local[part].items():
                    per = len(full[part][k]) // mesh.shape[axis]
                    assert np.array_equal(v, full[part][k][block * per:
                                                           (block + 1) * per])
            assert local[2] is full[2]


@pytest.mark.parametrize("seed", [3, 7])
def test_pipeline_step_one_rank_equals_jax(seed):
    """pipeline_step on a 1 x 1 cpu mesh (the kernels' plain versions)
    against the JAX package's on make_mesh(1, 1), impl="xla": likelihoods
    and best hap within rtol 1e-6 (module docstring), SW scores (seed 7
    has negative best scores), sorted keys and order exact."""
    mesh = make_mesh(1, 1, device="cpu")
    _, local = make_example_inputs(mesh, seed=seed)
    got = {k: v.numpy() for k, v in pipeline_step(mesh)(*local).items()}
    want = _jax_step(1, 1, seed, {})
    if seed == 7:
        assert (want["sw_scores"] < 0).any()
    _held_to_jax(got, want)
    assert got["likelihoods"].dtype == np.float32
    assert got["sw_scores"].dtype == np.int32


@pytest.mark.parametrize("world", sorted(MESH_CASES))
def test_pipeline_step_mesh_equals_jax(spawned, world):
    """The step on spawned gloo meshes of 2 x 2 and 4 x 2 ranks, gathered,
    against the JAX package's on the same mesh shape (tolerances as in the
    module docstring), and bit for bit against the port's one-rank step
    on the same global problem."""
    n_dp, n_hp, seed, kw = MESH_CASES[world]
    with np.load(spawned[world] / f"pipe_{n_dp}x{n_hp}_{seed}.npz") as z:
        got = {k: z[k] for k in z.files}
    _held_to_jax(got, _jax_step(n_dp, n_hp, seed, kw))
    r, h = kw.get("r_per_dev", 8), kw.get("h_per_dev", 4)
    mesh1 = make_mesh(1, 1, device="cpu")
    _, local = make_example_inputs(mesh1, r_per_dev=r * n_dp,
                                   h_per_dev=h * n_hp, seed=seed)
    one = {k: v.numpy() for k, v in pipeline_step(mesh1)(*local).items()}
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    np.testing.assert_array_equal(got["best_hap_lik"],
                                  got["likelihoods"].max(axis=1))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_distributed_sort_matches_numpy(spawned, p):
    """sort_records over p ranks of dp (spawned gloo meshes p x 1, or
    p x 2 for p = 2) equals a stable NumPy sort exactly, payloads
    included: keys over the full uint64 range with duplicates, 0 and the
    all-ones padding key itself (the sort is stable, ``parallel/sort.py``)."""
    world = 8 if p == 8 else 4
    (keys,) = [k for q, _, k in _sort_shapes(world) if q == p]
    with np.load(spawned[world] / f"sort_{p}x{world // p}.npz") as z:
        ks, vs = z["keys"], z["vals"]
    order = np.argsort(keys, kind="stable")
    assert ks.dtype == np.uint64 and len(ks) == len(keys)
    np.testing.assert_array_equal(ks, keys[order])
    np.testing.assert_array_equal(vs, order.astype(np.int32))


def test_sort_one_rank_and_non_power_of_two():
    """On a one-rank mesh sort_records equals a stable NumPy sort and
    sort_records_single over the full uint64 range; a dp axis of 3 ranks
    raises the JAX package's ValueError before any exchange."""
    keys = sort_keys_full_range(5, 777)
    vals = np.arange(len(keys), dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    ks, vs = S.sort_records(keys, vals, make_mesh(1, 1, device="cpu"))
    np.testing.assert_array_equal(ks, keys[order])
    np.testing.assert_array_equal(vs, order)
    k1, v1 = S.sort_records_single(keys, vals, device="cpu")
    np.testing.assert_array_equal(ks, k1)
    np.testing.assert_array_equal(vs, v1)
    three = Mesh(3, 1, 0, torch.device("cpu"), {"dp": None, "hp": None})
    with pytest.raises(ValueError, match="power of two"):
        S.sort_records(keys, vals, three)


def test_mesh_layout_and_one_rank_collectives():
    """Rank r sits at (r // n_hp, r % n_hp) with its groups' global ranks
    as the JAX package's reshape lays devices out; without a process group
    only 1 x 1 is valid (the JAX package's ValueError), and its gather is
    the identity."""
    m = Mesh(4, 2, 5, torch.device("cpu"), {"dp": None, "hp": None})
    assert (m.index("dp"), m.index("hp"), m.size) == (2, 1, 8)
    assert [m.global_rank("dp", i) for i in range(4)] == [1, 3, 5, 7]
    assert [m.global_rank("hp", i) for i in range(2)] == [4, 5]
    grid = np.arange(8).reshape(4, 2)
    assert grid[m.index("dp"), m.index("hp")] == 5
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        make_mesh(2, 1, device="cpu")
    one = make_mesh(device="cpu")
    assert one.shape == {"dp": 1, "hp": 1} and one.device.type == "cpu"
    t = torch.arange(6)
    assert all_gather(one, t, "dp") is t


@pytest.fixture(scope="module")
def map_case():
    """A small mapping problem: 96 reads of 100 bp at 1% error from a
    40 kbp reference, a third reverse-complemented."""
    from mgl_tpu_torch.pipelines.mapper import revcomp

    rng = np.random.default_rng(23)
    ref = rng.choice(BASES, size=40_000)
    starts = rng.integers(0, len(ref) - 100, size=96)
    reads = ref[starts[:, None] + np.arange(100)[None, :]].copy()
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    reads[::3] = revcomp(reads[::3])
    return ref, reads


def test_align_and_sort_one_rank_mesh_equals_none(map_case):
    """F2: align_and_sort(mesh=...) raised for every mesh; a one-rank mesh
    now takes the one-device sort and equals mesh=None in every output."""
    from mgl_tpu_torch.pipelines.align_sort import align_and_sort
    from mgl_tpu_torch.pipelines.mapper import ReferenceIndex

    ref, reads = map_case
    idx = ReferenceIndex.build(ref, k=16)
    a = align_and_sort(idx, reads, mesh=make_mesh(1, 1, device="cpu"),
                       device="cpu")
    b = align_and_sort(idx, reads, device="cpu")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_align_and_sort_two_rank_mesh_equals_jax(map_case, tmp_path):
    """F2: align_and_sort on a spawned 2-rank gloo mesh (2 x 1: the sort
    across dp) gives the JAX package's keys and order with
    align_and_sort(mesh=make_mesh(2, 1)) on the same reads.  The keys
    carry a unique tiebreak, so the order is defined."""
    from mgl_tpu.pipelines import align_sort as JA
    from mgl_tpu.pipelines.mapper import ReferenceIndex as JIndex

    ref, reads = map_case
    run_ranks(align_sort_rank, 2, "cpu", (ref, reads, str(tmp_path)),
              timeout=180)
    with np.load(tmp_path / "align_sort.npz") as z:
        keys, order = z["keys"], z["order"]
    want = JA.align_and_sort(
        JIndex.build(ref, k=16), reads, impl="xla",
        mesh=jax_mesh(2, 1))
    assert len(np.unique(want["keys"])) == len(reads)
    np.testing.assert_array_equal(keys, want["keys"])
    np.testing.assert_array_equal(order, want["order"])


def test_dryrun_multichip_cpu():
    """dryrun_multichip(4, "cpu"): a 2 x 2 gloo mesh, the sort ascending,
    best == the row maxima exactly, and the likelihoods and keys equal to
    a one-rank run of the same global problem."""
    got = dryrun_multichip(4, "cpu")
    assert got["likelihoods"].shape == (16, 8)


@pytest.mark.cuda
def test_pipeline_step_cuda_equals_cpu(cuda):
    """On the card: the step on a 1 x 1 mesh (pairhmm_banded_f32 and
    sw_banded score-only) equals the same step on the CPU (their plain
    versions) bit for bit, at seeds 3 and 7, and launches each kernel
    once."""
    from mgl_tpu_torch.kernels.pairhmm_cuda import pairhmm_banded_f32
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded

    for seed in (3, 7):
        outs = []
        for dev in (cuda, "cpu"):
            mesh = make_mesh(1, 1, device=dev)
            _, local = make_example_inputs(mesh, seed=seed)
            pairhmm_banded_f32.launches = sw_banded.launches = 0
            outs.append({k: v.cpu().numpy() for k, v in
                         pipeline_step(mesh)(*local).items()})
            if dev is cuda:
                assert pairhmm_banded_f32.launches == sw_banded.launches == 1
        for k in outs[0]:
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
