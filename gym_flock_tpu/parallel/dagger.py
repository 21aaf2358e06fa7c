"""DAGGER (dataset aggregation) imitation learning, fully on device.

The flocking papers train GNN policies with DAGGER rather than plain
behavior cloning: roll out under a mixture of expert and learner actions,
label every visited state with the expert, aggregate into a growing dataset,
and train on the aggregate.  Plain BC only sees expert states; DAGGER sees
the learner's own state distribution, which is what makes the distilled
policy stable in closed loop.

On-device formulation — everything is one jitted program per iteration:

* the replay buffer stores raw env states ``x`` (+ expert labels), not
  observations: features/adjacency are recomputed inside the loss, which is
  cheaper than storing [N, N] adjacency per sample and keeps the buffer at
  O(CAP * N * 4);
* the mixture policy flips a per-step Bernoulli(beta) coin between the
  expert action and the learner's action (the classic DAGGER-beta schedule);
* aggregation is a rolling ``dynamic_update_slice`` write into the
  fixed-capacity buffer.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from gym_flock_tpu.envs.flocking import (
    FlockingRelativeEnv,
    flocking_features,
    turner_controller,
)
from gym_flock_tpu.models.gnn import AggregationGNN

__all__ = ["DaggerTrainer", "DaggerState", "make_sharded_iteration"]


class DaggerState(NamedTuple):
    params: any
    opt_state: any
    buffer_x: jax.Array  # [CAP, N, 4]
    buffer_label: jax.Array  # [CAP, N, 2]
    write_pos: jax.Array  # int32
    filled: jax.Array  # int32


class DaggerTrainer:
    def __init__(
        self,
        env: FlockingRelativeEnv,
        env_params,
        model: Optional[AggregationGNN] = None,
        learning_rate: float = 1e-3,
        capacity: int = 4096,
        beta_decay: float = 0.7,
    ):
        self.env = env
        self.env_params = env_params
        self.model = model or AggregationGNN()
        self.tx = optax.adam(learning_rate)
        self.capacity = capacity
        self.beta_decay = beta_decay

    # ----------------------------------------------------------------- setup

    def init(self, key: jax.Array) -> DaggerState:
        n = self.env_params.n_agents
        params = self.model.init(key, jnp.zeros((n, 6)), jnp.zeros((n, n)))
        return DaggerState(
            params=params,
            opt_state=self.tx.init(params),
            buffer_x=jnp.zeros((self.capacity, n, 4)),
            buffer_label=jnp.zeros((self.capacity, n, 2)),
            write_pos=jnp.int32(0),
            filled=jnp.int32(0),
        )

    # ------------------------------------------------------------- internals

    def _policy_action(self, params, x):
        values, adj, adj_mean, _ = flocking_features(x, self.env_params.comm_radius2)
        net = adj_mean if self.env_params.mean_pooling else adj
        return self.model.apply(params, values, net)

    def _loss(self, params, xs, labels):
        def one(x, label):
            pred = self._policy_action(params, x)
            return jnp.mean((pred - label) ** 2)

        return jnp.mean(jax.vmap(one)(xs, labels))

    # -------------------------------------------------------------- one iter

    @partial(jax.jit, static_argnums=(0, 4, 5, 6))
    def iteration(
        self,
        state: DaggerState,
        key: jax.Array,
        beta: jax.Array,
        n_envs: int = 8,
        n_steps: int = 16,
        n_grad_steps: int = 4,
    ):
        """Collect under the beta-mixture, aggregate, train on the buffer."""
        env, p = self.env, self.env_params
        k_collect, k_train = jax.random.split(key)

        # ---- collect: mixture rollout, expert labels at every state
        def one_env(key):
            k_reset, k_scan = jax.random.split(key)
            s, _ = env.reset_env(k_reset, p)

            def body(s, key_t):
                k_coin, k_step = jax.random.split(key_t)
                x = s.x
                expert_u = turner_controller(x, p)
                learner_u = self._policy_action(state.params, x)
                use_expert = jax.random.bernoulli(k_coin, beta)
                u = jnp.where(use_expert, expert_u, learner_u)
                s2, _, _, _, _ = env.step_env(k_step, s, u, p)
                return s2, (x, expert_u)

            _, (xs, labels) = jax.lax.scan(
                body, s, jax.random.split(k_scan, n_steps)
            )
            return xs, labels  # [T, N, 4], [T, N, 2]

        keys = jax.random.split(k_collect, n_envs)
        xs, labels = jax.vmap(one_env)(keys)
        xs = xs.reshape(-1, *xs.shape[2:])
        labels = labels.reshape(-1, *labels.shape[2:])
        n_new = xs.shape[0]

        # ---- aggregate: rolling write (wraps at capacity)
        cap = self.capacity
        # a single scatter with duplicate indices would pair one sample's
        # state with another's expert label (per-key winners undefined) —
        # same guard as CoverageDaggerTrainer; make_sharded_iteration's
        # per-device capacity is cap // n_devices, so this also bounds the
        # sharded collection
        assert n_new <= cap, (
            f"n_envs*n_steps={n_new} exceeds buffer capacity={cap}; "
            f"raise capacity or collect less per iteration"
        )
        pos = state.write_pos
        idx = (pos + jnp.arange(n_new)) % cap
        buffer_x = state.buffer_x.at[idx].set(xs)
        buffer_label = state.buffer_label.at[idx].set(labels)
        write_pos = (pos + n_new) % cap
        filled = jnp.minimum(state.filled + n_new, cap)

        # ---- train on minibatches from the filled region
        def grad_step(carry, key_b):
            params, opt_state = carry
            batch_idx = jax.random.randint(key_b, (min(256, cap),), 0, filled)
            bx = buffer_x[batch_idx]
            bl = buffer_label[batch_idx]
            loss, grads = jax.value_and_grad(self._loss)(params, bx, bl)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            grad_step,
            (state.params, state.opt_state),
            jax.random.split(k_train, n_grad_steps),
        )

        new_state = DaggerState(
            params=params,
            opt_state=opt_state,
            buffer_x=buffer_x,
            buffer_label=buffer_label,
            write_pos=write_pos,
            filled=filled,
        )
        return new_state, jnp.mean(losses)

    # ------------------------------------------------------------------ fit

    def fit(
        self,
        key: jax.Array,
        n_iters: int = 10,
        ckpt_path: Optional[str] = None,
        ckpt_every: int = 0,
        resume: bool = True,
        **kwargs,
    ):
        """beta_k = beta_decay^k mixture schedule (beta_0 = 1: pure expert).

        ``ckpt_path``/``ckpt_every``/``resume`` checkpoint the FULL DAGGER
        state (params, optimizer, replay buffer, write cursor) plus the
        iteration and RNG key, so a resumed run replays the exact beta
        schedule and RNG stream of an uninterrupted one (see
        ``FlockingImitationTrainer.fit``)."""
        import os

        from gym_flock_tpu.parallel.train import restore_checkpoint, save_checkpoint

        k_init, key = jax.random.split(key)
        state = self.init(k_init)
        start = 0
        if ckpt_path and resume and os.path.exists(ckpt_path):
            state, _, start, saved_key = restore_checkpoint(ckpt_path, state, ())
            key = saved_key if saved_key is not None else key
        losses = []
        for k in range(start, n_iters):
            key, sub = jax.random.split(key)
            beta = jnp.asarray(self.beta_decay**k)
            state, loss = self.iteration(state, sub, beta, **kwargs)
            losses.append(float(loss))
            done = k + 1 == n_iters
            if ckpt_path and (done or (ckpt_every and (k + 1) % ckpt_every == 0)):
                save_checkpoint(ckpt_path, state, (), step=k + 1, key=key)
        return state, losses

    def evaluate(self, params, key: jax.Array, n_envs: int = 8, n_steps: int = 50):
        """Mean reward of the learner in closed loop (no expert)."""
        env, p = self.env, self.env_params

        def one(key):
            k_reset, k_scan = jax.random.split(key)
            s, _ = env.reset_env(k_reset, p)

            def body(s, kt):
                u = self._policy_action(params, s.x)
                s2, _, r, _, _ = env.step_env(kt, s, u, p)
                return s2, r

            _, rs = jax.lax.scan(body, s, jax.random.split(k_scan, n_steps))
            return jnp.mean(rs)

        return float(jnp.mean(jax.vmap(one)(jax.random.split(key, n_envs))))


def make_sharded_iteration(trainer: DaggerTrainer, mesh=None, n_envs: int = 16,
                           n_steps: int = 16, n_grad_steps: int = 4):
    """Data-parallel DAGGER iteration over a device mesh.

    Layout: model params / optimizer replicated; the replay buffer and the
    env batch shard along the mesh axis (each device aggregates its own
    shard and samples local minibatches); gradients and losses are
    ``pmean``-ed so all devices apply identical updates.  Returns
    ``(step_fn, mesh)`` where ``step_fn(state, key, beta)`` expects the
    buffer leaves of ``state`` to be device-sharded along axis 0 (e.g. via
    ``jax.device_put`` with a NamedSharding) or simply created under jit
    with the same mesh in scope.
    """
    from jax.sharding import PartitionSpec as P

    from gym_flock_tpu.parallel.rollout import make_env_mesh

    if mesh is None:
        mesh = make_env_mesh("dp")
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    assert n_envs % n_dev == 0 and trainer.capacity % n_dev == 0

    local_trainer = DaggerTrainer(
        trainer.env, trainer.env_params, trainer.model,
        capacity=trainer.capacity // n_dev, beta_decay=trainer.beta_decay,
    )
    local_trainer.tx = trainer.tx

    def local_step(state, keys, beta):
        # state buffers are the local shard; keys: [1] local key
        new_state, loss = local_trainer.iteration(
            state, keys[0], beta,
            n_envs=n_envs // n_dev, n_steps=n_steps, n_grad_steps=n_grad_steps,
        )
        # NOTE: iteration() applies a local update; re-average params so all
        # devices stay in lockstep (equivalent to pmean'd grads for Adam up
        # to the optimizer's nonlinearity; exact lockstep is restored every
        # step by the pmean of the updated params)
        params = jax.lax.pmean(new_state.params, axis)
        # pmean on int32 demotes to float32 (e.g. Adam's step count); int
        # leaves are identical across devices anyway, so only average floats
        opt_state = jax.tree.map(
            lambda a: jax.lax.pmean(a, axis)
            if jnp.issubdtype(a.dtype, jnp.floating)
            else a,
            new_state.opt_state,
        )
        loss = jax.lax.pmean(loss, axis)
        return new_state._replace(params=params, opt_state=opt_state), loss

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            DaggerState(
                params=P(), opt_state=P(),
                buffer_x=P(axis), buffer_label=P(axis),
                write_pos=P(), filled=P(),
            ),
            P(axis),
            P(),
        ),
        out_specs=(
            DaggerState(
                params=P(), opt_state=P(),
                buffer_x=P(axis), buffer_label=P(axis),
                write_pos=P(), filled=P(),
            ),
            P(),
        ),
    )

    @jax.jit
    def step(state, key, beta):
        keys = jax.random.split(key, n_dev)
        return sharded(state, keys, beta)

    def init(key):
        # build the GLOBAL state whose buffers shard along axis 0
        full = DaggerTrainer(
            trainer.env, trainer.env_params, trainer.model,
            capacity=trainer.capacity, beta_decay=trainer.beta_decay,
        )
        full.tx = trainer.tx
        return full.init(key)

    return step, init, mesh
