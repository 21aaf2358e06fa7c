"""Networked LQR on a random geometric graph.

Batched, jit-compiled re-design of reference gym_flock/envs/linear/lqr.py:12-108 (config
values inlined from linear/params_lqr.cfg): node positions drawn uniformly,
system matrix A = RBF kernel of positions, exact discretization via matrix
exponential (reference :47-53, ``scipy.linalg.expm`` -> here
``jax.scipy.linalg.expm``), degree-k nearest-neighbor communication graph
(sklearn -> ``lax.top_k``), quadratic cost x'Qx + u'Ru.

Where the reference builds the system once in ``__init__`` with global
``np.random`` (:34), here system construction is a keyed pure function
(:func:`build_lqr_system`) so batched envs can draw independent systems.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from gym_flock_tpu.core import struct

from gym_flock_tpu.core.env import Env, EnvState
from gym_flock_tpu.core.spaces import Box

__all__ = ["LQRParams", "LQRState", "LQREnv", "build_lqr_system", "lqr_factory"]


# The system build, the Riccati sweep, the dynamics and the expert are
# float32 products that a GPU would otherwise run in TF32 (about three
# decimal digits); the dynamics are the environment, not a model, so they
# keep full float32 precision on every backend.
def _highest():
    return jax.default_matmul_precision("highest")


@struct.dataclass
class LQRSystem:
    a_net: jax.Array  # [n, n] communication graph (masked RBF kernel)
    a_sys: jax.Array  # [n, n] discretized dynamics e^{dt A}
    b_sys: jax.Array  # [n, n]
    q_sys: jax.Array  # [n, n]
    r_sys: jax.Array  # [n, n]
    std_dev: jax.Array  # scalar process-noise std
    # Riccati gain, precomputed by build_lqr_system (state-independent —
    # recomputing the 50-iteration fixed point per expert call was ~50
    # dense solves/matmuls per step); None falls back to computing in
    # controller() for hand-built systems
    k_gain: jax.Array | None = None


@struct.dataclass
class LQRParams:
    """Values from params_lqr.cfg (network_size=100, alpha=10, dt=0.01,
    variance=0.01, xmax=1, b_scale=10, degree=8, filter_length=4)."""

    # NOTE: the cfg's filter_length is intentionally NOT carried: the only
    # thing the reference does with it is shape an observation_space that
    # does not match its actual (x, a_net) observation (lqr.py:71; the
    # x_agg aggregation that would consume it is commented out, :89)
    n_nodes: int = struct.field(pytree_node=False, default=100)
    degree: int = struct.field(pytree_node=False, default=8)
    max_steps: int = struct.field(pytree_node=False, default=1000)

    dt: float = 0.01
    alpha: float = 10.0
    var: float = 0.01
    x_max: float = 1.0
    b_scale: float = 10.0
    max_u: float = 40.0
    max_z: float = 200.0

    system: Any = None  # LQRSystem (built per key or shared)


@struct.dataclass
class LQRState(EnvState):
    x: jax.Array  # [n, 1]


def build_lqr_system(key: jax.Array, params: LQRParams) -> LQRSystem:
    """Construct the networked linear system (reference lqr.py:32-61)."""
    n = params.n_nodes
    node_loc = params.alpha * jax.random.uniform(key, (n, 2))

    # RBF kernel with sklearn's default gamma = 1/n_features = 1/2
    d2 = jnp.sum((node_loc[:, None, :] - node_loc[None, :, :]) ** 2, axis=-1)
    a_sys = jnp.exp(-0.5 * d2)
    a_sys = jnp.where(jnp.eye(n, dtype=bool), 0.0, a_sys)

    # degree-k nearest-neighbor mask (reference :39-42)
    d2_inf = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, d2)
    _, idx = jax.lax.top_k(-d2_inf, params.degree)
    knn = jnp.zeros((n, n)).at[jnp.arange(n)[:, None], idx].set(1.0)
    a_net = a_sys * knn
    # nonsymmetric eigvals are CPU-only in JAX; spectral-radius normalization
    # is setup-time math, so do it host-side
    import numpy as _np

    rho = float(_np.max(_np.abs(_np.linalg.eigvals(_np.asarray(a_net)))))
    a_net = a_net / rho

    with _highest():
        a_expm = jax.scipy.linalg.expm(params.dt * a_sys)
        eye = jnp.eye(n)
        b_sys = jnp.linalg.inv(a_sys) @ (a_expm - eye) @ (params.b_scale * eye)
        q_sys = jnp.linalg.inv(2.0 * a_sys) @ (
            jax.scipy.linalg.expm(params.dt * 2.0 * a_sys) - eye
        )
    q_sys = (q_sys + q_sys.T) / 2.0
    r_sys = params.dt * eye * (params.b_scale**2)
    cov00 = q_sys[0, 0] * params.var
    sys = LQRSystem(
        a_net=a_net,
        a_sys=a_expm,
        b_sys=b_sys,
        q_sys=q_sys,
        r_sys=r_sys,
        std_dev=jnp.sqrt(cov00),
    )
    return sys.replace(k_gain=_riccati_gain(sys))


def _riccati_gain(sys: LQRSystem) -> jax.Array:
    """Infinite-horizon discrete LQR gain by 50 fixed-point sweeps
    (state-independent; shared by build_lqr_system and the controller
    fallback so the two are bitwise-identical)."""

    def body(P, _):
        a, b, q, r = sys.a_sys, sys.b_sys, sys.q_sys, sys.r_sys
        btpb = b.T @ P @ b
        k = jnp.linalg.solve(r + btpb, b.T @ P @ a)
        P2 = q + a.T @ P @ (a - b @ k)
        return P2, None

    with _highest():
        P, _ = jax.lax.scan(body, sys.q_sys, None, length=50)
        a, b, r = sys.a_sys, sys.b_sys, sys.r_sys
        return jnp.linalg.solve(r + b.T @ P @ b, b.T @ P @ a)


class LQREnv(Env[LQRParams, LQRState]):
    def default_params(self) -> LQRParams:
        params = LQRParams()
        return params.replace(system=build_lqr_system(jax.random.key(0), params))

    def reset_env(self, key, params: LQRParams):
        x = jax.random.uniform(
            key, (params.n_nodes, 1), minval=-params.x_max, maxval=params.x_max
        )
        state = LQRState(time=jnp.int32(0), x=x)
        return state, (state.x, params.system.a_net)

    def step_env(self, key, state: LQRState, action, params: LQRParams):
        sys = params.system
        xt = state.x.reshape((params.n_nodes, 1))
        ut = jnp.reshape(action, (params.n_nodes, 1))
        noise = sys.std_dev * jax.random.normal(key, (params.n_nodes, 1))
        with _highest():
            xt1 = sys.a_sys @ xt + sys.b_sys @ ut + noise
            cost = (xt.T @ sys.q_sys @ xt + ut.T @ sys.r_sys @ ut)[0, 0]
        new_state = state.replace(x=xt1, time=state.time + 1)
        done = new_state.time >= params.max_steps
        return new_state, (xt1, sys.a_net), -cost, done, {}

    def controller(self, state, params):
        """The reference controller is a no-op (lqr.py:106-107); provide the
        infinite-horizon LQR gain as the natural expert (extension)."""
        sys = params.system
        # the gain is state-independent: precomputed at system build; the
        # fixed-point fallback serves hand-built LQRSystems
        k = sys.k_gain if sys.k_gain is not None else _riccati_gain(sys)
        with _highest():
            return -(k @ state.x.reshape((-1, 1)))

    def observation_space(self, params):
        return Box(-params.max_z, params.max_z, (params.n_nodes, 1))

    def action_space(self, params):
        return Box(-params.max_u, params.max_u, (params.n_nodes, 1))


def lqr_factory(**kwargs):
    env = LQREnv()
    params = LQRParams(**kwargs) if kwargs else LQRParams()
    if params.system is None:
        params = params.replace(system=build_lqr_system(jax.random.key(0), params))
    return env, params
