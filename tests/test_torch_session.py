"""Port parity, modules scene/session.py and utils/knn.py: the JAX
package's session checks (tests/test_session.py) on the port, snapshots that
stay what they were when the live state is written in place, and knn /
nearest against the JAX functions on seeded points: the same indices, ties
included (both order equal distances by index), distances within 1e-6
(a 3-term sum of squares; XLA:CPU may contract it into multiply-adds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxk_tpu.utils import knn as jknn
from dxk_tpu_torch.physics import PhysicsSettings, physics_step
from dxk_tpu_torch.scene import SceneBuilder
from dxk_tpu_torch.scene.session import SceneSession
from dxk_tpu_torch.utils import knn as tknn

# In a process that also runs JAX, the first torch.sqrt call on this CPU build
# of PyTorch can come back at reduced precision (~2e-4 relative; later calls
# are exact). The port shares a process with JAX only in these tests, so that
# first call is spent here.
torch.sqrt(torch.ones(4096))


def _make():
    b = SceneBuilder()
    g = b.add_static()
    b.add_box_collider(g, (0, -1, 0), (20, 1, 20))
    bd = b.add_body(position=(0, 2, 0))
    b.add_sphere_collider(bd, (0, 0, 0), 0.5)
    scene = b.finalize(device="cpu")
    settings = PhysicsSettings()

    def step(s):
        return physics_step(scene, s, settings, 1 / 120)[0]
    return scene, step


def test_play_stop_restores_editor_state():
    scene, step = _make()
    sess = SceneSession(scene, step)
    y0 = float(sess.state.pos[0, 1, 1])
    sess.play()
    for _ in range(60):
        sess.step()
    assert float(sess.state.pos[0, 1, 1]) < y0 - 0.05
    sess.stop()
    assert float(sess.state.pos[0, 1, 1]) == y0
    assert not sess.playing


def test_pause_freezes_stepping():
    scene, step = _make()
    sess = SceneSession(scene, step)
    sess.play()
    sess.step()
    y = sess.state.pos.clone()
    sess.pause()
    for _ in range(10):
        sess.step()
    assert torch.equal(sess.state.pos, y)
    sess.resume()
    sess.step()
    assert not torch.equal(sess.state.pos, y)


def test_undo_stack():
    scene, step = _make()
    sess = SceneSession(scene, step)

    def nudge(st):
        pos = st.pos.clone()
        pos[0, 1, 0] += 1.0
        return st.replace(pos=pos)

    x0 = float(sess.state.pos[0, 1, 0])
    sess.edit(nudge)
    sess.edit(nudge)
    assert float(sess.state.pos[0, 1, 0]) == x0 + 2.0
    assert sess.undo_depth == 2
    sess.undo()
    assert float(sess.state.pos[0, 1, 0]) == x0 + 1.0
    sess.undo()
    assert float(sess.state.pos[0, 1, 0]) == x0
    sess.undo()
    assert float(sess.state.pos[0, 1, 0]) == x0


def test_snapshots_are_clones():
    """An edit or step that writes the live state in place leaves the play
    snapshot and the undo stack as they were."""
    scene, _step = _make()

    def step_in_place(st):
        st.pos[0, 1, 1] -= 0.5
        return st

    sess = SceneSession(scene, step_in_place)
    y0 = float(sess.state.pos[0, 1, 1])
    sess.snapshot()
    sess.play()
    sess.step()
    sess.step()
    assert float(sess.state.pos[0, 1, 1]) == y0 - 1.0
    sess.stop()
    assert float(sess.state.pos[0, 1, 1]) == y0
    step_in_place(sess.state)
    assert float(sess.undo().pos[0, 1, 1]) == y0
    host = sess.device_get()
    host.pos[0, 1, 1] = 99.0
    assert float(sess.state.pos[0, 1, 1]) == y0


def test_pick_nearest_body():
    """The query next to the dynamic sphere picks it over the static
    ground, in every env."""
    scene, step = _make()
    sess = SceneSession(scene, step, scene.initial_state(3))
    idx, sq = sess.pick_nearest_body((0.1, 2.0, 0.0))
    assert idx.tolist() == [[1]] * 3
    assert float(sq.max()) < 0.02


@pytest.mark.parametrize("k,masked", [(1, False), (3, False), (5, True)])
def test_knn_matches_jax(k, masked):
    rng = np.random.default_rng(k)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    # exact ties: points repeated at other indices, a query on a point
    pts[50:60] = pts[10:20]
    q = rng.normal(size=(6, 3)).astype(np.float32)
    q[0] = pts[15]
    mask = rng.random(100) < 0.7 if masked else None
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    jidx, jsq = jknn.knn(jnp.asarray(pts), jnp.asarray(q), k, jm)
    tidx, tsq = tknn.knn(torch.from_numpy(pts), torch.from_numpy(q), k, tm)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), atol=1e-6)
    ji, jd = jknn.nearest(jnp.asarray(pts), jnp.asarray(q[0]), jm)
    ti, td = tknn.nearest(torch.from_numpy(pts), torch.from_numpy(q[0]), tm)
    assert int(ti) == int(ji)
    ref = np.argsort(((q[:, None] - pts[None]) ** 2).sum(-1), axis=1,
                     kind="stable")
    if not masked:
        np.testing.assert_array_equal(tidx.numpy(), ref[:, :k])
