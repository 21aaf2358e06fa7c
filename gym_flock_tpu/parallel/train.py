"""Imitation-learning trainer: expert data generation + sharded train step.

This is the workload the reference exists for (README.md:25-30: env experts
generate imitation data for GNN policies trained in an external repo).  Here
the whole loop is fused on device:

    rollout (vmapped envs, expert policy) -> (obs, expert actions)
    -> policy gradient step (MSE to expert) -> repeat

and shards it over a device mesh: the env-batch/data axis is partitioned
across devices (dp), model parameters are replicated, and gradients are
combined with ``psum`` (SURVEY.md §5.8).  ``jax.distributed.initialize`` extends the same program
to multi-host; nothing in the code changes because the mesh abstracts hosts.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

from gym_flock_tpu.core.env import Env
from gym_flock_tpu.models.gnn import AggregationGNN
from gym_flock_tpu.parallel.rollout import make_env_mesh, rollout

__all__ = [
    "FlockingImitationTrainer",
    "LargeFlockingImitationTrainer",
    "collect_flocking_batch",
    "collect_large_flocking_batch",
    "make_dp_train_step",
]


def collect_flocking_batch(env: Env, params, key: jax.Array, n_envs: int, n_steps: int):
    """Expert-driven rollouts keeping (features, adjacency, expert action).

    Returns leaves shaped [n_envs * n_steps, ...] — a flat supervised
    dataset.
    """

    def one(key):
        _, traj = rollout(
            env, params, key, n_steps=n_steps, policy="expert", keep_obs=True
        )
        return traj

    keys = jax.random.split(key, n_envs)
    traj = jax.vmap(one)(keys)
    feats, adj = traj.obs  # [B, T, N, 6], [B, T, N, N]
    acts = traj.action  # [B, T, N, 2]
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    return flat(feats), flat(adj), flat(acts)


def make_dp_train_step(tx, local_loss_fn, mesh=None):
    """Generic data-parallel train step over a 1-D mesh.

    ``local_loss_fn(params, key) -> loss`` computes this device's loss from
    its local env-key shard; grads/losses are pmean'd across the mesh axis
    so every device applies an identical optax update.  Shared by the
    flocking and coverage imitation trainers (identical layout: keys
    sharded, params/optimizer replicated).
    """
    from jax.sharding import PartitionSpec as P

    from gym_flock_tpu.parallel.rollout import make_env_mesh

    if mesh is None:
        mesh = make_env_mesh("dp")
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    def local_step(params, opt_state, keys):
        loss, grads = jax.value_and_grad(local_loss_fn)(params, keys[0])
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(), P(axis)), out_specs=(P(), P(), P()),
    )

    @jax.jit
    def step(carry, key):
        params, opt_state = carry
        keys = jax.random.split(key, n_dev)
        params, opt_state, loss = sharded(params, opt_state, keys)
        return (params, opt_state), loss

    return step, mesh


class FlockingImitationTrainer:
    """End-to-end on-device DAGGER-style behavior cloning for flocking.

    The policy is the K-hop :class:`AggregationGNN`; supervision is the
    Turner expert.  ``train_step`` is a single jitted program: collect a
    fresh expert batch, compute the MSE loss and gradients, apply the optax
    update.  ``make_sharded_train_step`` wraps it in ``shard_map`` over an
    env/data mesh axis with psum'd gradients — the canonical DP layout.
    """

    def __init__(
        self,
        env: Env,
        env_params,
        model: Optional[AggregationGNN] = None,
        learning_rate: float = 1e-3,
    ):
        self.env = env
        self.env_params = env_params
        self.model = model or AggregationGNN()
        self.tx = optax.adam(learning_rate)

    def init(self, key: jax.Array):
        n = self.env_params.n_agents
        feats = jnp.zeros((n, 6))
        adj = jnp.zeros((n, n))
        params = self.model.init(key, feats, adj)
        return params, self.tx.init(params)

    def loss_fn(self, params, feats, adj, actions):
        """MSE to expert actions; batched over the leading axis."""
        pred = jax.vmap(lambda f, a: self.model.apply(params, f, a))(feats, adj)
        return jnp.mean((pred - actions) ** 2)

    @partial(jax.jit, static_argnums=(0, 4, 5))
    def train_step(self, carry, key, _unused=None, n_envs: int = 8, n_steps: int = 8):
        params, opt_state = carry
        feats, adj, acts = collect_flocking_batch(
            self.env, self.env_params, key, n_envs, n_steps
        )
        loss, grads = jax.value_and_grad(self.loss_fn)(params, feats, adj, acts)
        updates, opt_state = self.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    # ------------------------------------------------------------- sharded

    def make_sharded_train_step(
        self, mesh=None, n_envs: int = 16, n_steps: int = 8
    ) -> Tuple[Callable, Any]:
        """Data-parallel train step over a device mesh.

        Env keys shard along the mesh axis (each device rolls its own env
        shard and computes local grads); params/opt-state are replicated;
        grads and loss are ``pmean``-ed across the axis before the update so
        every device applies an identical step.
        """
        if mesh is None:
            mesh = make_env_mesh()
        n_dev = mesh.devices.size
        assert n_envs % n_dev == 0
        local_envs = n_envs // n_dev

        def local_loss(params, key):
            feats, adj, acts = collect_flocking_batch(
                self.env, self.env_params, key, local_envs, n_steps
            )
            return self.loss_fn(params, feats, adj, acts)

        return make_dp_train_step(self.tx, local_loss, mesh=mesh)

    def fit(
        self,
        key: jax.Array,
        n_iters: int = 20,
        n_envs: int = 8,
        n_steps: int = 8,
        ckpt_path: Optional[str] = None,
        ckpt_every: int = 0,
        resume: bool = True,
    ):
        """Single-device training driver; returns (params, losses).

        With ``ckpt_path`` the loop checkpoints (params, opt state,
        iteration, RNG key) every ``ckpt_every`` iterations (and at the
        end), and — when ``resume`` and the file exists — continues from
        the saved iteration with the exact RNG stream of an uninterrupted
        run, so interrupt + resume reproduces the straight-through result.
        """
        import os

        k_init, key = jax.random.split(key)
        carry = self.init(k_init)
        start = 0
        if ckpt_path and resume and os.path.exists(ckpt_path):
            p, o, start, saved_key = restore_checkpoint(ckpt_path, *carry)
            carry = (p, o)
            key = saved_key if saved_key is not None else key
        losses = []
        for i in range(start, n_iters):
            key, sub = jax.random.split(key)
            carry, loss = self.train_step(carry, sub, None, n_envs, n_steps)
            losses.append(float(loss))
            done = i + 1 == n_iters
            if ckpt_path and (done or (ckpt_every and (i + 1) % ckpt_every == 0)):
                save_checkpoint(ckpt_path, carry[0], carry[1], step=i + 1, key=key)
        return carry[0], losses


def collect_large_flocking_batch(env, params, key: jax.Array, n_envs: int, n_steps: int):
    """Expert rollouts on :class:`LargeFlockingEnv` keeping (x, features,
    expert action) — the adjacency is NEVER materialized; the large GNN
    re-derives neighborhoods on the fly from ``x``
    (``models.LargeAggregationGNN``).  The expert's and the observation's
    fused pairwise passes share one ``flocking_sums`` call (CSE: same input).

    Returns leaves shaped [n_envs * n_steps, ...].
    """

    def one(key):
        key, kreset = jax.random.split(key)
        state, _ = env.reset_env(kreset, params)

        def body(state, key_t):
            u = env.controller(state, params)
            values, _ = env._obs(state, params)
            x = state.x
            state, _, _, _, _ = env.step_env(key_t, state, u, params)
            return state, (x, values, u)

        _, traj = jax.lax.scan(body, state, jax.random.split(key, n_steps))
        return traj

    keys = jax.random.split(key, n_envs)
    xs, feats, acts = jax.vmap(one)(keys)  # [B, T, N, ...]
    flat = lambda v: v.reshape((-1,) + v.shape[2:])
    return flat(xs), flat(feats), flat(acts)


class LargeFlockingImitationTrainer:
    """Behavior cloning at swarm sizes where the dense adjacency does not
    fit: :class:`LargeAggregationGNN` over (x, features) batches, every
    pairwise product tile by tile (``ops.adjacency_matmul``) with the
    custom-VJP backward.
    Mirrors :class:`FlockingImitationTrainer` otherwise.
    """

    def __init__(
        self,
        env,
        env_params,
        model=None,
        learning_rate: float = 1e-3,
    ):
        from gym_flock_tpu.models.gnn import LargeAggregationGNN

        self.env = env
        self.env_params = env_params
        self.model = model or LargeAggregationGNN(
            comm_radius2=float(env_params.comm_radius2)
        )
        self.tx = optax.adam(learning_rate)

    def init(self, key: jax.Array):
        n = self.env_params.n_agents
        params = self.model.init(key, jnp.zeros((n, 4)), jnp.zeros((n, 6)))
        return params, self.tx.init(params)

    def loss_fn(self, params, xs, feats, actions):
        pred = jax.vmap(lambda x, f: self.model.apply(params, x, f))(xs, feats)
        return jnp.mean((pred - actions) ** 2)

    @partial(jax.jit, static_argnums=(0, 3, 4))
    def train_step(self, carry, key, n_envs: int = 2, n_steps: int = 4):
        params, opt_state = carry
        xs, feats, acts = collect_large_flocking_batch(
            self.env, self.env_params, key, n_envs, n_steps
        )
        loss, grads = jax.value_and_grad(self.loss_fn)(params, xs, feats, acts)
        updates, opt_state = self.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    def fit(self, key: jax.Array, n_iters: int = 10, n_envs: int = 2, n_steps: int = 4):
        k_init, key = jax.random.split(key)
        carry = self.init(k_init)
        losses = []
        for _ in range(n_iters):
            key, sub = jax.random.split(key)
            carry, loss = self.train_step(carry, sub, n_envs, n_steps)
            losses.append(float(loss))
        return carry[0], losses

    # --------------------------------------------------- agent-axis sharded

    def make_agent_sharded_train_step(
        self,
        mesh=None,
        axis_name: str = "ap",
    ):
        """Train step with the AGENT axis sharded over the mesh (model
        parallelism for the swarm dimension, SURVEY §5.7) — for N past one
        device's memory.  Params replicate; (x, features, actions) batches
        shard along agents; the K-hop aggregation runs the ppermute ring of
        ``parallel.agent_shard.khop_aggregate_sharded`` (differentiable
        through each tile's custom VJP); gradients pmean over the axis.

        Returns ``(step, mesh)``; ``step((params, opt_state), (xs, feats,
        acts)) -> ((params, opt_state), loss)`` with [B, N, ...] batches
        (collect them with :func:`collect_large_flocking_batch`).
        """
        from gym_flock_tpu.parallel.agent_shard import khop_aggregate_sharded
        from gym_flock_tpu.parallel.rollout import make_env_mesh

        if mesh is None:
            mesh = make_env_mesh(axis_name)
        aggregate = partial(
            khop_aggregate_sharded,
            comm_radius2=float(self.env_params.comm_radius2),
            k_hops=self.model.k_hops,
            axis_name=axis_name,
        )
        model_sh = self.model.clone(aggregate_fn=aggregate)

        def local_step(params, opt_state, xs_l, feats_l, acts_l):
            def loss_fn(p):
                pred = jax.vmap(lambda x, f: model_sh.apply(p, x, f))(xs_l, feats_l)
                # equal-size shards: the mean of local means IS the global mean
                return jnp.mean((pred - acts_l) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = jax.lax.pmean(grads, axis_name)
            loss = jax.lax.pmean(loss, axis_name)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        sharded = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P(), P(None, axis_name), P(None, axis_name), P(None, axis_name)),
            out_specs=(P(), P(), P()),
        )

        @jax.jit
        def step(carry, batch):
            params, opt_state = carry
            xs, feats, acts = batch
            params, opt_state, loss = sharded(params, opt_state, xs, feats, acts)
            return (params, opt_state), loss

        return step, mesh


# =============================================================================
# Checkpoint / resume (the reference has none — SURVEY.md §5.4)
# =============================================================================


def save_checkpoint(path: str, params, opt_state, step: int = 0, key=None) -> None:
    """Serialize trainer state: ``np.savez`` of the flattened pytree leaves.

    ``step`` and the training PRNG ``key`` make the checkpoint resumable
    mid-run (``fit(ckpt_path=..., resume=True)`` picks up at iteration
    ``step`` with the exact RNG stream it would have had).  Written via a
    temp file + atomic rename so a crash mid-write never leaves a torn
    checkpoint behind.
    """
    import os

    leaves = jax.tree.leaves((params, opt_state))
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    arrays["step"] = np.int64(step)
    if key is not None:
        arrays["key_data"] = np.asarray(jax.random.key_data(key))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore_checkpoint(path: str, params_template, opt_state_template):
    """Restore trainer state into pytrees of the same structure.

    Returns ``(params, opt_state, step, key)``; ``key`` is None for
    checkpoints saved without one.  Raises ``ValueError`` when the file's
    leaf count does not match the templates.
    """
    treedef = jax.tree.structure((params_template, opt_state_template))
    with np.load(path) as data:
        n = sum(1 for name in data.files if name.startswith("leaf_"))
        if n != treedef.num_leaves:
            raise ValueError(
                f"checkpoint {path} holds {n} leaves, the templates "
                f"{treedef.num_leaves}"
            )
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
        step = int(data["step"])
        key_data = data["key_data"] if "key_data" in data.files else None
    params, opt_state = jax.tree.unflatten(treedef, leaves)
    key = None if key_data is None else jax.random.wrap_key_data(jnp.asarray(key_data))
    return params, opt_state, step, key
