"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from xcontour_tpu.parallel import make_mesh, shard_batch_spec, sharded_weighted_cdf
from xcontour_tpu.ops.histogram import weighted_cdf
from xcontour_tpu.pipeline import keff_lwa_pipeline
from xcontour_tpu import grid as G


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_sharded_cdf_matches_single(mesh, rng):
    B, Ny, Nx = 8, 32, 64
    v = rng.normal(size=(B, Ny, Nx)).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=(Ny, Nx)).astype(np.float64)
    bins = np.linspace(v.min(), v.max(), 21)
    tr = jax.device_put(jnp.asarray(v), shard_batch_spec(mesh, 3))
    got = sharded_weighted_cdf(tr, jnp.asarray(bins), jnp.asarray(w), True, mesh)
    want = weighted_cdf(jnp.asarray(v), jnp.asarray(bins), jnp.asarray(w), True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


def test_sharded_exact_sort_matches_single(mesh, rng):
    """Sharded exact-sort CDF (SURVEY §2.4 'global sort = local sort +
    merge'): local sort + prefix per X slab, psum of the N level sums across
    devices == the single-device ops/sort.py engine at f64.  Scales reference
    core.py:363-409 exactly."""
    from xcontour_tpu.parallel import sharded_exact_conditional_integral
    from xcontour_tpu.ops.sort import exact_conditional_integral
    B, Ny, Nx = 8, 32, 64
    v = rng.normal(size=(B, Ny, Nx)).astype(np.float64)
    v[0, 3, 5] = np.nan                       # NaN values contribute nothing
    w = rng.uniform(0.5, 2.0, size=(Ny, Nx)).astype(np.float64)
    tr = jax.device_put(jnp.asarray(v), shard_batch_spec(mesh, 3))
    for lt in (True, False):
        # replicated (N,) bins and per-batch (B, N) bins, both directions
        bins_r = np.linspace(np.nanmin(v), np.nanmax(v), 21)
        bins_b = np.stack([np.linspace(np.nanmin(v[i]), np.nanmax(v[i]), 21)
                           for i in range(B)])
        for bins in (bins_r, bins_b[:, ::-1].copy(), bins_b):
            got = sharded_exact_conditional_integral(
                tr, jnp.asarray(bins), jnp.asarray(w), lt, mesh)
            want = exact_conditional_integral(
                jnp.asarray(v), jnp.asarray(bins), jnp.asarray(w), lt)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-12,
                                       err_msg=f"lt={lt} bins{bins.shape}")


def test_sharded_exact_sort_matches_broadcast_oracle(mesh, rng):
    """And against the strict-comparison broadcast path (the reference's
    definition), not just the single-device sort twin."""
    from xcontour_tpu.parallel import sharded_exact_conditional_integral
    from xcontour_tpu.core import cal_integral_within_contours
    B, Ny, Nx = 8, 16, 32
    v = rng.normal(size=(B, Ny, Nx)).astype(np.float64)
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx)).astype(np.float64)
    bins = np.linspace(v.min() - 0.1, v.max() + 0.1, 13)
    tr = jax.device_put(jnp.asarray(v), shard_batch_spec(mesh, 3))
    got = sharded_exact_conditional_integral(
        tr, jnp.asarray(bins), jnp.asarray(dA), True, mesh)
    want = cal_integral_within_contours(jnp.asarray(v), jnp.asarray(bins),
                                        jnp.asarray(dA), lt=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


def test_sharded_pipeline_matches_unsharded(mesh, rng):
    """GSPMD: the full combined Keff+LWA step gives identical results when its
    inputs are sharded (batch x spatial) over the mesh."""
    Ny, Nx = 24, 48
    lat = np.linspace(-80, 80, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    B = 8
    tracer = (np.sin(np.deg2rad(lat))[None, :, None]
              + 0.1 * rng.standard_normal((B, Ny, Nx)))
    plain = keff_lwa_pipeline(jnp.asarray(tracer), grid, N=11,
                              increase=True, lt=True, lmin="analytic")
    tr = jax.device_put(jnp.asarray(tracer), shard_batch_spec(mesh, 3))
    shard = keff_lwa_pipeline(tr, grid, N=11, increase=True, lt=True,
                              lmin="analytic")
    for k in ("intArea", "Yeq", "Leq2", "lwa"):
        np.testing.assert_allclose(np.asarray(shard[k]), np.asarray(plain[k]),
                                   rtol=1e-9, atol=1e-12, equal_nan=True,
                                   err_msg=k)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_sharded_stencil_matches_local(mesh, rng):
    """Explicit ppermute halo exchange reproduces the single-device stencil."""
    from xcontour_tpu.parallel.stencil import sharded_squared_gradient
    from xcontour_tpu.ops.stencil import squared_gradient
    Ny, Nx = 24, 64
    lat = np.linspace(-80, 80, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    q = rng.normal(size=(8, Ny, Nx))
    tr = jax.device_put(jnp.asarray(q), shard_batch_spec(mesh, 3))
    got = sharded_squared_gradient(tr, grid, mesh)
    want = squared_gradient(jnp.asarray(q), grid)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


def test_sharded_lwa_matches_local(mesh, rng):
    """X-sharded LWA is communication-free and exact: each device reduces its
    own longitude slab (the weight normalization max(dA) must still be global,
    so dA is passed whole and sliced by shard_map)."""
    from xcontour_tpu.parallel.lwa import sharded_local_wave_activity
    from xcontour_tpu.diagnostics.lwa import local_wave_activity
    B, Ny, Nx = 8, 16, 32
    ydef = np.linspace(-60, 60, Ny)
    q = rng.normal(size=(B, Ny, Nx))
    dA = rng.uniform(0.5, 2.0, size=(Ny, Nx))  # x-varying: exposes any
    # per-shard (instead of global) max(dA) normalization bug
    Q = np.sort(rng.normal(size=(B, Ny)), axis=-1)
    tr = jax.device_put(jnp.asarray(q), shard_batch_spec(mesh, 3))
    got = sharded_local_wave_activity(tr, jnp.asarray(Q), jnp.asarray(dA),
                                      jnp.asarray(ydef), mesh, increase=True)
    want = local_wave_activity(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(dA),
                               jnp.asarray(ydef), increase=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


def test_pallas_kernels_under_shard_map(mesh, rng):
    """Pallas x sharding composition: the LWA c-term kernel (interpret mode
    on the CPU mesh) runs inside jax.shard_map over the batch and x axes
    and reproduces its own unsharded result — every output column depends
    only on its own input column, so neither axis needs communication.
    check_vma is off because pallas_call does not annotate varying-mesh
    axes."""
    from jax.sharding import PartitionSpec as P
    from xcontour_tpu.diagnostics.lwa import _lin_v1_terms
    from xcontour_tpu.kernels.lwa_pallas import lwa_lin_pallas

    B, Ny, Nx = 4, 16, 64
    q = jnp.asarray(np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1),
                    jnp.float32)
    Q = jnp.sort(jnp.mean(q, axis=-1), axis=-1)
    W = jnp.asarray(rng.uniform(0.5, 2.0, size=(Ny, Nx)), jnp.float32)
    qk, Qc, _, E = _lin_v1_terms(q, Q, W, True)

    def kern(a, b, c, d):
        return lwa_lin_pallas(a, b, c, d, increase=True, interpret=True,
                              tj=8, bx=16, yb=4)

    want = kern(qk, Qc, W, E)
    mesh2 = make_mesh(8, x_size=2)
    fn = jax.jit(jax.shard_map(
        kern, mesh=mesh2,
        in_specs=(P("batch", None, "x"), P("batch"), P(None, "x"),
                  P("batch", None, "x")),
        out_specs=P("batch", None, "x"), check_vma=False))
    got = fn(qk, Qc, W, E)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(jnp.abs(want).max()))


def test_clength_fractal_pipelines_sharded(mesh, rng):
    """The geometry pipelines give identical results with mesh-sharded
    batches (the batch-parallel execution model of reference
    core.py:1006-1012)."""
    from xcontour_tpu.pipeline import clength_pipeline, fractal_pipeline
    Ny, Nx = 16, 32
    lat = np.linspace(-75, 75, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    B = 8
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.1 * rng.standard_normal((B, Ny, Nx)))
    tr = jax.device_put(jnp.asarray(q), shard_batch_spec(mesh, 3))

    plain = clength_pipeline(jnp.asarray(q), grid, N=9, increase=True, lt=True)
    shard = clength_pipeline(tr, grid, N=9, increase=True, lt=True)
    for k in ("lengths", "Leq2", "cmGrd"):
        np.testing.assert_allclose(np.asarray(shard[k]), np.asarray(plain[k]),
                                   rtol=1e-9, equal_nan=True, err_msg=k)

    plainf = fractal_pipeline(jnp.asarray(q), grid, N=9, strides=(1, 2),
                              increase=True, lt=True)
    shardf = fractal_pipeline(tr, grid, N=9, strides=(1, 2),
                              increase=True, lt=True)
    for k in ("lengths", "D", "bclens"):
        np.testing.assert_allclose(np.asarray(shardf[k]),
                                   np.asarray(plainf[k]),
                                   rtol=1e-9, equal_nan=True, err_msg=k)


def test_sharded_contour_lengths_matches_local(mesh, rng):
    """X-sharded perimeter lengths: one halo column over the ring, local
    cells, psum — equals the single-device geometry exactly, including the
    NaN masking of land and the no-seam-cell convention."""
    from xcontour_tpu.parallel import sharded_contour_lengths
    from xcontour_tpu.diagnostics.length import contour_lengths
    B, Ny, Nx = 8, 24, 64
    lat = np.linspace(-75, 75, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.15 * rng.standard_normal((B, Ny, Nx)))
    q[:, 5:8, 10:20] = np.nan                     # land mask crossing shards
    ctr = np.stack([np.linspace(np.nanmin(t), np.nanmax(t), 9) for t in q])

    want = contour_lengths(jnp.asarray(q), jnp.asarray(ctr),
                           jnp.asarray(lat), jnp.asarray(lon), latlon=True)
    tr = jax.device_put(jnp.asarray(q), shard_batch_spec(mesh, 3))
    got = sharded_contour_lengths(tr, jnp.asarray(ctr), jnp.asarray(lat),
                                  jnp.asarray(lon), mesh, latlon=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, equal_nan=True)


def test_sharded_local_lengths_matches_local(mesh, rng):
    """Windowed local lengths with the window list sharded across the mesh:
    one all_gather of the X-sharded tracer, block-sharded window evaluation —
    equals the single-device windowed path exactly (NaN windows included)."""
    from xcontour_tpu.parallel import sharded_local_lengths
    from xcontour_tpu.diagnostics.local_length import local_contour_lengths
    from jax.sharding import NamedSharding, PartitionSpec as P

    Ny, Nx = 40, 64
    lat = np.linspace(-75, 75, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    q = (np.sin(np.deg2rad(lat))[:, None]
         + 0.15 * rng.standard_normal((Ny, Nx)))
    q[12:30, 20:26] = np.nan                      # an all-NaN window exists
    want, wy, wx = local_contour_lengths(jnp.asarray(q), jnp.asarray(lat),
                                         jnp.asarray(lon), window=17,
                                         stride=5, latlon=True)
    tr = jax.device_put(jnp.asarray(q), NamedSharding(mesh, P(None, "x")))
    got, gy, gx = sharded_local_lengths(tr, jnp.asarray(lat), jnp.asarray(lon),
                                        mesh, window=17, stride=5, latlon=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(np.asarray(gy), np.asarray(wy))
    np.testing.assert_allclose(np.asarray(gx), np.asarray(wx))


def test_sharded_local_lengths_x_heavy_mesh(mesh, rng):
    """The same path on a 1x8 x-heavy mesh (all devices on the window axis)."""
    from xcontour_tpu.parallel import sharded_local_lengths
    from xcontour_tpu.diagnostics.local_length import local_contour_lengths

    mesh8 = make_mesh(8, x_size=8)
    assert mesh8.shape["x"] == 8 and mesh8.shape["batch"] == 1
    Ny, Nx = 24, 48
    lat = np.linspace(-60, 60, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    q = (np.sin(np.deg2rad(lat))[:, None]
         + 0.1 * rng.standard_normal((Ny, Nx)))
    want, _, _ = local_contour_lengths(jnp.asarray(q), jnp.asarray(lat),
                                       jnp.asarray(lon), window=9,
                                       stride=4, latlon=False)
    got, _, _ = sharded_local_lengths(jnp.asarray(q), jnp.asarray(lat),
                                      jnp.asarray(lon), mesh8, window=9,
                                      stride=4, latlon=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, equal_nan=True)


def test_sharded_adjoint_matches_unsharded(mesh, rng):
    """Distributed adjoint: jax.grad of the combined Keff+LWA loss with
    batch-sharded inputs (GSPMD over the 8-device mesh) equals the
    unsharded gradient — the custom VJPs (CDF weight cotangent, lin-twin
    LWA backward, safe divisions) all compose with sharding."""
    Ny, Nx = 24, 48
    lat = np.linspace(-80, 80, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = G.from_latlon(lat, lon, dtype=jnp.float64)
    B = 8
    tracer = (np.sin(np.deg2rad(lat))[None, :, None]
              + 0.1 * rng.standard_normal((B, Ny, Nx)))

    def loss(t):
        out = keff_lwa_pipeline(t, grid, N=11, increase=True, lt=True,
                                lmin="analytic")
        return jnp.nansum(out["lwa"] * out["lwa"]) + jnp.nansum(out["nkeff"])

    g_plain = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(tracer)))
    tr = jax.device_put(jnp.asarray(tracer), shard_batch_spec(mesh, 3))
    g_shard = np.asarray(jax.jit(jax.grad(loss))(tr))
    assert np.isfinite(g_plain).all()
    np.testing.assert_allclose(g_shard, g_plain, rtol=1e-9,
                               atol=1e-12 * np.abs(g_plain).max())


def test_hybrid_mesh_single_process_reduces_to_make_mesh(mesh, rng):
    """make_hybrid_mesh on one process == make_mesh over all devices, and a
    pipeline sharded over it matches the unsharded result (the multi-host
    placement itself needs several hosts; the single-process contract is
    what one host can pin)."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.parallel import make_hybrid_mesh, shard_batch_spec
    from xcontour_tpu import grid as G
    from xcontour_tpu.pipeline import keff_lwa_pipeline

    hm = make_hybrid_mesh()
    assert hm.devices.size == len(jax.devices())
    assert hm.axis_names == ("batch", "x")

    Ny, Nx = 16, 32
    grid = G.from_latlon(np.linspace(-75, 75, Ny), np.arange(Nx) * 11.25,
                         dtype=jnp.float64)
    t = jnp.asarray(np.cumsum(rng.normal(size=(8, Ny, Nx)), axis=1))
    want = keff_lwa_pipeline(t, grid, N=7, increase=True, lt=True,
                             lmin="analytic")
    ts = jax.device_put(t, shard_batch_spec(hm, t.ndim))
    got = keff_lwa_pipeline(ts, grid, N=7, increase=True, lt=True,
                            lmin="analytic")
    np.testing.assert_allclose(np.asarray(got["nkeff"]),
                               np.asarray(want["nkeff"]),
                               rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got["lwa"]),
                               np.asarray(want["lwa"]),
                               rtol=1e-12, atol=1e-12, equal_nan=True)


def test_sharded_stencil_honors_bc_and_nonperiodic(mesh, rng):
    """sharded_squared_gradient must follow THIS grid's flags: non-periodic
    X uses one-sided edge columns (no wraparound halo), and the Y wall BC is
    the grid's bc_y — pinned against ops.stencil.squared_gradient."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu import grid as G
    from xcontour_tpu.ops.stencil import squared_gradient
    from xcontour_tpu.parallel.stencil import sharded_squared_gradient

    Ny, Nx = 12, 32
    for bc in ("extend", "reflect", "fill"):
        grid = G.from_cartesian(np.arange(Ny) * 50.0, np.arange(Nx) * 80.0,
                                periodic_x=False, dtype=jnp.float64)
        grid = G.Grid(**{**{f.name: getattr(grid, f.name)
                            for f in __import__("dataclasses").fields(grid)},
                         "bc_y": bc})
        q = jnp.asarray(rng.normal(size=(8, Ny, Nx)))
        want = squared_gradient(q, grid)
        got = sharded_squared_gradient(q, grid, mesh)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-15, err_msg=bc)


class _FakeDev:
    def __init__(self, i, proc):
        self.id = i
        self.process_index = proc

    def __repr__(self):
        return f"d{self.id}@p{self.process_index}"


def test_hybrid_device_array_topology():
    """The factored multi-host placement: 2 hosts x 4 devices, any
    x_size — every 'x' row stays within ONE host and hosts stack along the
    batch axis in host order."""
    from xcontour_tpu.parallel.mesh import hybrid_device_array

    devs = [_FakeDev(i, i // 4) for i in range(8)]

    arr = hybrid_device_array(devs, x_size=4)
    assert arr.shape == (2, 4)
    assert [d.process_index for d in arr[0]] == [0] * 4
    assert [d.process_index for d in arr[1]] == [1] * 4
    assert [d.id for d in arr.ravel()] == list(range(8))

    arr2 = hybrid_device_array(devs, x_size=2)
    assert arr2.shape == (4, 2)
    for row in arr2:
        assert len({d.process_index for d in row}) == 1  # one host per row
    assert [d.process_index for d in arr2[:, 0]] == [0, 0, 1, 1]

    # interleaved enumeration order must not leak across slices either
    shuffled = [devs[i] for i in (3, 4, 0, 7, 1, 5, 2, 6)]
    arr3 = hybrid_device_array(shuffled, x_size=2)
    for row in arr3:
        assert len({d.process_index for d in row}) == 1
    assert [d.process_index for d in arr3[:, 0]] == [0, 0, 1, 1]

    # 4 hosts x 2 devices, x_size=2: one 'x' row per host
    devs4 = [_FakeDev(i, i // 2) for i in range(8)]
    arr4 = hybrid_device_array(devs4, x_size=2)
    assert arr4.shape == (4, 2)
    assert [d.process_index for d in arr4[:, 0]] == [0, 1, 2, 3]

    with pytest.raises(ValueError, match="uneven"):
        hybrid_device_array([_FakeDev(0, 0), _FakeDev(1, 0),
                             _FakeDev(2, 1)], x_size=1)
    with pytest.raises(ValueError, match="divisible"):
        hybrid_device_array(devs, x_size=3)


def test_make_mesh_rejects_indivisible_x_size():
    import jax
    from xcontour_tpu.parallel import make_mesh

    n = len(jax.devices())
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(x_size=n + 7)


def test_hybrid_mesh_default_x_size_is_whole_slice():
    """make_hybrid_mesh(slice_of=..., x_size=None) defaults each slice's
    local devices to one whole 'x' group: 2 fake hosts over the
    virtual 8-CPU mesh -> a (2, 4) mesh with pure-slice rows."""
    import jax
    from xcontour_tpu.parallel import make_hybrid_mesh

    if len(jax.devices()) != 8:
        pytest.skip("needs the virtual 8-device mesh")

    hm = make_hybrid_mesh(slice_of=lambda d: d.id // 4)
    assert hm.devices.shape == (2, 4)
    for row in hm.devices:
        assert len({d.id // 4 for d in row}) == 1


def test_hybrid_mesh_multislice_on_virtual_devices(rng):
    """The multi-slice make_hybrid_mesh branch EXECUTES on the virtual
    8-CPU mesh: slice_of attributes devices to 2 fake hosts, the mesh
    comes out (4, 2) with single-host 'x' rows, and the combined pipeline
    sharded over it matches the unsharded result."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu.parallel import make_hybrid_mesh, shard_batch_spec
    from xcontour_tpu import grid as G
    from xcontour_tpu.pipeline import keff_lwa_pipeline

    if len(jax.devices()) != 8:
        pytest.skip("needs the virtual 8-device mesh")

    hm = make_hybrid_mesh(x_size=2, slice_of=lambda d: d.id // 4)
    assert hm.devices.shape == (4, 2)
    for row in hm.devices:
        assert len({d.id // 4 for d in row}) == 1     # 'x' never crosses hosts
    assert [d.id // 4 for d in hm.devices[:, 0]] == [0, 0, 1, 1]

    Ny, Nx = 16, 32
    grid = G.from_latlon(np.linspace(-75, 75, Ny), np.arange(Nx) * 11.25,
                         dtype=jnp.float64)
    t = jnp.asarray(np.cumsum(rng.normal(size=(8, Ny, Nx)), axis=1))
    want = keff_lwa_pipeline(t, grid, N=7, increase=True, lt=True,
                             lmin="analytic")
    ts = jax.device_put(t, shard_batch_spec(hm, t.ndim))
    got = keff_lwa_pipeline(ts, grid, N=7, increase=True, lt=True,
                            lmin="analytic")
    np.testing.assert_allclose(np.asarray(got["nkeff"]),
                               np.asarray(want["nkeff"]),
                               rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got["lwa"]),
                               np.asarray(want["lwa"]),
                               rtol=1e-12, atol=1e-12, equal_nan=True)


def test_hybrid_mesh_multiprocess_default_attribution(monkeypatch):
    """The multi-host branch (process_count > 1, no slice_of): devices are
    attributed by process_index and the topology-aware placement is
    attempted, falling back to enumeration order on backends without device
    coords (this virtual CPU mesh).  Single-process coverage via a
    monkeypatched process_count — all virtual devices share process 0, so
    the mesh must come out (1, n) with every device in one 'x' row."""
    import jax
    from xcontour_tpu.parallel import make_hybrid_mesh

    n = len(jax.devices())
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    hm = make_hybrid_mesh()
    assert hm.devices.shape == (1, n)
    assert [d.id for d in hm.devices[0]] == sorted(d.id for d in jax.devices())


def test_topology_fallback_warns_only_on_real_accelerators():
    """_warn_topology_fallback names the placement error on real
    accelerators (ADVICE r4 #3) and stays silent for CPU/virtual devices."""
    import warnings
    from xcontour_tpu.parallel.mesh import _warn_topology_fallback

    class FakeDev:
        def __init__(self, platform):
            self.platform = platform

    with warnings.catch_warnings():
        warnings.simplefilter("error")          # any warning -> failure
        _warn_topology_fallback([FakeDev("cpu")] * 4, ValueError("no coords"))

    with pytest.warns(UserWarning, match="topology-aware placement "
                                         "unavailable.*no coords"):
        _warn_topology_fallback([FakeDev("cpu"), FakeDev("gpu")],
                                ValueError("no coords"))
