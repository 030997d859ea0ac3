"""The port's animated, K-buffer, ring, view and ray-traced frames on four
gloo ranks against the JAX package's.

tests/test_torch_parallel.py holds these frames equal on every value to
the port's single-device frames; here a second group of four ranks
(tests/torch_parallel_ranks.py, started once by a module fixture through
the port's own bootstrap) renders them again while this process renders
the JAX package's counterparts on its virtual CPU mesh
(tests/torch_parallel_jax.py), and each is held against JAX's within the
case's limits.  They sit in a file of their own because their JAX frames
take the longest to compile (the balanced-row K-buffer runs JAX's tile
kernel interpreted).
"""

import concurrent.futures

import pytest

import torch_parallel_jax as tj
import torch_parallel_ranks as ranks

N = 4


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The ranks' results and the JAX package's frame of every case (or
    the exception it raised), rendered in this process while the ranks
    run."""
    out_dir = str(tmp_path_factory.mktemp("paths4"))
    procs = ranks.start_group(N, out_dir, names=ranks.PATH_CASES)
    try:
        # Two threads: the balanced-row K-buffer's interpreted kernel alone
        # takes about as long as the other cases together.
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = {name: pool.submit(tj.jax_frame, name)
                    for name in ranks.PATH_CASES}
        want = {name: job.exception() or job.result()
                for name, job in jobs.items()}
    finally:
        out = ranks.join_group(procs, out_dir)
    errors = [r["error"] for r in out if r["error"]]
    assert not errors, "\n".join(errors)
    return out, want


@pytest.mark.parametrize("name", ranks.PATH_CASES)
def test_four_rank_path_matches_jax(rendered, name):
    """The animated frame (against JAX's single-device frame: JAX's sharded
    frame cannot run its normal-mapped shader), the K-buffer over
    contiguous and balanced-row bands, the ring at n = 4, four views and
    the ray-traced bands with and without clusters, each equal on every
    rank, against JAX's render_frame_sharded, render_frame_ring,
    render_frame_views and render_frame_raytraced_sharded on a mesh of the
    same shape (torch_parallel_jax.jax_frame), within the case's limits
    (torch_parallel_jax.close)."""
    out, want = rendered
    if isinstance(want[name], Exception):
        raise want[name]
    frames = [r["frames"][name] for r in out]
    for c, d in frames[1:]:
        assert (c == frames[0][0]).all() and (d == frames[0][1]).all()
    tj.close(name, frames[0], want[name])
