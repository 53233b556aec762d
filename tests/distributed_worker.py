"""Worker process for the true multi-process distributed test
(tests/test_distributed.py).  Two of these run concurrently, forming one
jax.distributed job over 2 processes x 4 virtual CPU devices = 8 global
devices — the CPU stand-in for the reference's manual multi-node sharding
replacement (README.md:1049-1067 -> one SPMD job).

Usage: python distributed_worker.py <process_id> <port> <workdir> \
           [n_processes] [local_devices]
Exits non-zero on any assertion failure; writes <workdir>/ok.<pid> on success.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    pid, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    n_procs = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    local_dev = int(sys.argv[5]) if len(sys.argv) > 5 else 4
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_dev} "
        + os.environ.get("XLA_FLAGS", "")
    )
    sys.path.insert(0, REPO)

    import numpy as np

    from kpop_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=n_procs,
        process_id=pid,
    )

    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_global = n_procs * local_dev
    assert jax.process_count() == n_procs
    assert jax.process_index() == pid
    assert len(jax.devices()) == n_global
    assert len(jax.local_devices()) == local_dev
    assert distributed.is_primary() == (pid == 0)

    from kpop_tpu.core.ca import fit_ca
    from kpop_tpu.parallel.checkpoint import load_sharded, save_sharded
    from kpop_tpu.parallel.input import (
        encode_fasta_batches,
        global_batch,
        shard_files_for_process,
    )
    from kpop_tpu.parallel.mesh import DATA_AXIS, KMER_AXIS, make_mesh
    from kpop_tpu.parallel.sharded import ca_fit_sharded

    mesh = make_mesh()

    # ---- P2 scatter: round-robin file assignment ----
    files = [os.path.join(workdir, f"in{i}.fasta") for i in range(4)]
    mine = shard_files_for_process(files)
    assert mine == files[pid::n_procs], (mine, pid)

    # ---- per-process encode + global assembly ----
    local_batch = 16 // n_procs
    batches = list(encode_fasta_batches(mine, batch=local_batch, max_len=16))
    assert len(batches) == 1, len(batches)
    codes, names = batches[0]
    assert codes.shape == (local_batch, 16) and len(names) == local_batch
    codes_f, names_f = codes, list(names)  # kept for the P3 merge stage
    g = global_batch(mesh, codes)
    assert g.shape == (16, 16), g.shape
    got_sum = float(jax.jit(lambda a: (a.astype("int32") + 1).sum())(g))
    # expected from ALL files, computed on host by every process
    exp = 0
    for b, _ in encode_fasta_batches(files, batch=16, max_len=16):
        exp += int((b.astype(np.int32) + 1).sum())
    assert got_sum == exp, (got_sum, exp)

    # ---- sharded checkpoint round-trip across process files ----
    arr_host = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    spec = P((DATA_AXIS, KMER_AXIS), None)
    arr = jax.device_put(arr_host, NamedSharding(mesh, spec))
    ck = os.path.join(workdir, "ckpt")
    save_sharded(ck, arr)
    multihost_utils.sync_global_devices("ckpt written")
    assert os.path.exists(ck + f".shard{pid}.kpopckpt")
    assert os.path.exists(ck + ".kpopckpt")  # meta from process 0
    back = load_sharded(ck, mesh, spec)
    assert back.shape == arr_host.shape
    for s in back.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), arr_host[s.index])

    # ---- sharded CA parity with the host golden path ----
    rng = np.random.default_rng(42)  # same table on both processes
    table = rng.random((101, 7)) * 10.0
    coords, inertia, twister, sv = ca_fit_sharded(mesh, table)
    want = fit_ca(table)
    np.testing.assert_allclose(coords, want.sample_coords, rtol=0, atol=2e-4)
    np.testing.assert_allclose(inertia, want.inertia, rtol=0, atol=1e-4)
    np.testing.assert_allclose(sv, want.sv, rtol=0, atol=1e-4)
    assert twister.shape == want.twister.shape
    np.testing.assert_allclose(twister, want.twister, rtol=0, atol=5e-3)

    # ---- kmer-sharded serving across processes (parallel/serving.py) ----
    import jax.numpy as jnp

    from kpop_tpu.core.kmers import KmerSpace
    from kpop_tpu.ops.pipeline import ClassifierParams
    from kpop_tpu.parallel.serving import (
        shard_classifier_params,
        sharded_dmat_fn,
    )

    space = KmerSpace("DNA-ds", 5)
    rngs = np.random.default_rng(7)  # identical params on both processes
    V, d, C, B, L = 96, 8, 5, 8, 64
    vocab_codes = np.sort(rngs.choice(space.n_kmers, size=V, replace=False))
    lut = np.full(space.n_kmers + 1, V, dtype=np.int32)
    lut[vocab_codes.astype(np.int64)] = np.arange(V, dtype=np.int32)
    tw = rngs.standard_normal((V, d)).astype(np.float32)
    ccoords = rngs.standard_normal((C, d)).astype(np.float32)
    metric = np.full(d, 1.0 / d, dtype=np.float32)
    cn = np.sqrt((ccoords.astype(np.float64) ** 2 * metric).sum(axis=1))
    cn = np.where(cn == 0.0, 1.0, cn)
    params = ClassifierParams(
        jnp.asarray(lut), jnp.asarray(tw), jnp.asarray(metric),
        jnp.asarray(ccoords), jnp.asarray(cn.astype(np.float32)), 5, True,
    )
    sp, vg = shard_classifier_params(params, mesh)
    assert vg == V
    # the twister must be spread over BOTH processes' devices
    assert len(sp.twister.addressable_shards) < len(sp.twister.sharding.device_set)
    codes = rngs.integers(0, 4, size=(B, L)).astype(np.int8)
    gb = jax.make_array_from_callback(
        (B, L),
        NamedSharding(mesh, P(DATA_AXIS, None)),
        lambda idx: codes[idx],
    )
    dmat = sharded_dmat_fn(mesh, vg)(sp, gb)
    # host golden: numpy count -> normalize over known -> project -> distance
    code_to_col = {int(c): i for i, c in enumerate(vocab_codes)}

    def tv_of(row_codes) -> "np.ndarray":
        spec = np.zeros(V)
        for c in space.window_codes(row_codes):
            col = code_to_col.get(int(c))
            if col is not None:
                spec[col] += 1.0
        total = spec.sum()
        if total:
            spec /= total
        return spec @ tw.astype(np.float64)

    want = np.zeros((B, C))
    for b in range(B):
        tv = tv_of(codes[b])
        na = float(np.sqrt((tv**2 * metric).sum())) or 1.0
        aa = tv / na
        bb = ccoords.astype(np.float64) / cn[:, None]
        want[b] = np.sqrt(np.maximum(
            ((aa[None, :] - bb) ** 2 * metric[None, :]).sum(axis=1), 0.0
        ))
    for s in dmat.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(s.data, dtype=np.float64), want[s.index], atol=1e-4
        )

    # ---- P3 `-a` merge: per-process twisted chunk files -> one register
    # (the reference's manual multi-node scatter + merge, README.md:
    # 1049-1067: each node projects its input shard, the results are
    # merged with KPopTwistDB -a) ----
    from kpop_tpu.cli import twistdb as twistdb_cli
    from kpop_tpu.core.matrix import KPopMatrix, MatrixType, NamedMatrix

    dim_names = ["Dim%d" % (i + 1) for i in range(d)]
    local_tv = np.stack([tv_of(codes_f[b]) for b in range(len(names_f))])
    part = KPopMatrix(
        MatrixType.TWISTED, NamedMatrix(names_f, dim_names, local_tv)
    )
    part.to_binary(os.path.join(workdir, "part%d" % pid))
    multihost_utils.sync_global_devices("parts written")
    if pid == 0:
        argv = ["-i", "t", os.path.join(workdir, "part0")]
        for i in range(1, n_procs):
            argv += ["-a", "t", os.path.join(workdir, "part%d" % i)]
        argv += ["-o", "t", os.path.join(workdir, "merged")]
        rc = twistdb_cli.main(argv)
        assert rc == 0, rc
        merged = KPopMatrix.of_binary(
            MatrixType.TWISTED, os.path.join(workdir, "merged")
        )
        exp_rows = {}
        for cb, nb in encode_fasta_batches(files, batch=16, max_len=16):
            for b, nm in enumerate(nb):
                exp_rows[nm] = tv_of(cb[b])
        assert sorted(merged.matrix.row_names) == sorted(exp_rows), (
            merged.matrix.row_names
        )
        for nm, row in zip(merged.matrix.row_names, merged.matrix.data):
            np.testing.assert_allclose(row, exp_rows[nm], atol=1e-12)
    multihost_utils.sync_global_devices("merged checked")

    with open(os.path.join(workdir, f"ok.{pid}"), "w") as f:
        json.dump({"process": pid, "devices": len(jax.devices())}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
