"""Measured training-quality pipelines.

The reference exists to generate imitation data for GNN policies
(reference README.md:25-30); this script closes the loop and RECORDS the
numbers: each pipeline trains a policy on the device and reports final
expert-action accuracy and learned-policy vs expert vs random episode
reward — on the training bank AND a held-out bank of real-facility
sub-windows the training never sampled.

Pipelines (one per invocation; results merge into --out):

  bc_greedy  — behavior cloning of the greedy expert (EdgeGraphNet) on
               CoverageARL real-map sub-windows.
  bc_vrp     — the label-sensitivity experiment: ONE set of
               greedy-behavior rollout states labeled TWICE by the C++
               VRP expert (canonical or_default descent vs the
               last_accept enumeration-order probe), two identical-init
               models trained on the two label sets, and the downstream
               deltas (cross-label accuracy, closed-loop reward)
               recorded next to the raw label-flip rate.
  dagger     — CoverageDaggerTrainer (mixture rollouts, rolling buffer).
  flocking   — FlockingImitationTrainer (AggregationGNN, Turner expert):
               action MSE + closed-loop mean episode reward for
               policy / expert / random.

Usage: python benchmarks/train_quality.py <pipeline> [--out FILE]
"""
import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp

import gym_flock_tpu as gft
from gym_flock_tpu.utils.cache import enable_compile_cache

OUT_DEFAULT = str(Path(__file__).parent.parent / "chiprun_out" / "train_quality.json")


def merge_out(path: str, name: str, entry: dict):
    p = Path(path)
    data = json.loads(p.read_text()) if p.exists() else {}
    data[name] = entry
    p.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    print(f"wrote {name} -> {path}")


def coverage_world():
    """Train bank + held-out bank: disjoint random sub-windows of the real
    ARL facility map (CoverageARL semantics, reference coverage_arl.py)."""
    env, params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=0)
    _, eval_params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=1234)
    return env, params, eval_params


def random_reward(env, params, key, n_envs=64, n_steps=50):
    """Mean episode reward of uniform-random actions (the floor)."""

    @jax.jit
    def run(key):
        def one(key):
            k_reset, k_scan = jax.random.split(key)
            state, obs = env.reset_env(k_reset, params)

            def body(carry, key_t):
                state, obs = carry
                ka, ks = jax.random.split(key_t)
                u = jax.random.randint(
                    ka, (params.n_robots,), 0, params.n_actions, dtype=jnp.int32
                )
                state, obs, r, _, _ = env.step_env(ks, state, u, params)
                return (state, obs), r

            _, rs = jax.lax.scan(
                body, (state, obs), jax.random.split(k_scan, n_steps)
            )
            return jnp.sum(rs)

        return jnp.mean(jax.vmap(one)(jax.random.split(key, n_envs)))

    return float(run(key))


def run_bc_greedy(out, n_iters=800, latent=64, rounds=6, lr=1e-3):
    from gym_flock_tpu.models.gnn import EdgeGraphNet
    from gym_flock_tpu.parallel.train_coverage import CoverageImitationTrainer

    env, params, eval_params = coverage_world()
    model = EdgeGraphNet(latent=latent, rounds=rounds)
    trainer = CoverageImitationTrainer(env, params, model=model,
                                       learning_rate=lr)
    t0 = time.time()
    key = jax.random.key(0)
    carry, losses = trainer.fit(key, n_iters=n_iters, n_envs=8, n_steps=16)
    dur = time.time() - t0
    k_eval = jax.random.key(99)
    train_m = trainer.evaluate(carry[0], k_eval, params, n_envs=64, n_steps=50)
    held_m = trainer.evaluate(carry[0], k_eval, eval_params, n_envs=64, n_steps=50)
    rand_train = random_reward(env, params, k_eval)
    rand_held = random_reward(env, eval_params, k_eval)
    entry = {
        "pipeline": "coverage BC, greedy expert labels (EdgeGraphNet)",
        "world": "CoverageARL-v0, 8 real-facility sub-windows, R=4",
        "model": {"latent": latent, "rounds": rounds, "lr": lr},
        "train": {"n_iters": n_iters, "samples_per_iter": 128,
                  "loss_first": round(losses[0], 4),
                  "loss_last": round(float(np.mean(losses[-10:])), 4),
                  "seconds": round(dur, 1)},
        "train_bank": {**{k: round(v, 4) for k, v in train_m.items()},
                       "random_reward": round(rand_train, 2)},
        "heldout_bank": {**{k: round(v, 4) for k, v in held_m.items()},
                         "random_reward": round(rand_held, 2)},
    }
    merge_out(out, "bc_greedy", entry)


def _collect_states(env, params, key, n_envs, n_steps):
    """Greedy-behavior rollout keeping obs graphs AND raw state fields
    (same device program as parallel.vrp_labels.collect_vrp_labeled_batch,
    but returning the states so they can be labeled under SEVERAL modes)."""

    @jax.jit
    def roll(key):
        def one(key):
            k_reset, k_scan = jax.random.split(key)
            state, obs = env.reset_env(k_reset, params)

            def body(carry, key_t):
                state, obs = carry
                k1, k2 = jax.random.split(key_t)
                u = env.controller(state, params, key=k1, greedy=True)
                state2, obs2, r, d, _ = env.step_env(k2, state, u, params)
                sample = {
                    "nodes": obs["nodes"], "edges": obs["edges"],
                    "senders": obs["senders"], "receivers": obs["receivers"],
                    "graph": state.graph, "robot_loc": state.robot_loc,
                    "visited": state.visited, "discovered": state.discovered,
                    "time": state.time,
                }
                return (state2, obs2), sample

            _, traj = jax.lax.scan(
                body, (state, obs), jax.random.split(k_scan, n_steps)
            )
            return traj

        traj = jax.vmap(one)(jax.random.split(key, n_envs))
        return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), traj)

    flat = roll(key)
    states = {k: flat.pop(k)
              for k in ("graph", "robot_loc", "visited", "discovered", "time")}
    return flat, states


def _epoch_train(trainer, batch, key, n_epochs=60, minibatch=64):
    """Fixed-dataset BC: shuffled minibatch epochs of update_from_batch."""
    n = int(np.asarray(batch["label"]).shape[0])
    carry = trainer.init(jax.random.key(7))  # identical init across label sets
    losses = []
    for ep in range(n_epochs):
        key, sub = jax.random.split(key)
        perm = np.asarray(jax.random.permutation(sub, n))
        for lo in range(0, n - minibatch + 1, minibatch):
            mb = {k: v[perm[lo:lo + minibatch]] for k, v in batch.items()}
            carry, loss = trainer.update_from_batch(carry, mb)
        losses.append(float(loss))
    return carry, losses


def run_bc_vrp(out, n_envs=32, n_steps=32, workers=2):
    from gym_flock_tpu.parallel.train_coverage import CoverageImitationTrainer
    from gym_flock_tpu.parallel.vrp_labels import vrp_label_states

    env, params, eval_params = coverage_world()
    trainer = CoverageImitationTrainer(env, params)
    key = jax.random.key(0)
    batch, states = _collect_states(env, params, key, n_envs, n_steps)
    states = {k: np.asarray(v) for k, v in states.items()}
    n = states["graph"].shape[0]

    t0 = time.time()
    lab_canon = vrp_label_states(params, states, mode="or_default",
                                 workers=workers)
    t_canon = time.time() - t0
    t0 = time.time()
    lab_probe = vrp_label_states(params, states, mode="or_default",
                                 workers=workers, last_accept=True)
    t_probe = time.time() - t0
    flip = float(np.mean(lab_canon != lab_probe))

    results = {}
    evals = {}
    for name, labels in (("or_default", lab_canon), ("last_accept", lab_probe)):
        b = dict(batch)
        b["label"] = jnp.asarray(labels)
        t0 = time.time()
        carry, losses = _epoch_train(trainer, b, jax.random.key(3))
        dur = time.time() - t0
        pm = carry[0]
        # accuracy against BOTH label sets (cross-accuracy bounds the
        # practical cost of the enumeration-order ambiguity)
        acc_own = float(trainer.accuracy(pm, {**batch, "label": jnp.asarray(labels)}))
        other = lab_probe if name == "or_default" else lab_canon
        acc_cross = float(trainer.accuracy(pm, {**batch, "label": jnp.asarray(other)}))
        ev_train = trainer.evaluate(pm, jax.random.key(99), params,
                                    n_envs=64, n_steps=50)
        ev_held = trainer.evaluate(pm, jax.random.key(99), eval_params,
                                   n_envs=64, n_steps=50)
        results[name] = {
            "loss_last": round(float(np.mean(losses[-5:])), 4),
            "train_seconds": round(dur, 1),
            "acc_on_own_labels": round(acc_own, 4),
            "acc_on_other_labels": round(acc_cross, 4),
            "closedloop_train": {k: round(v, 4) for k, v in ev_train.items()},
            "closedloop_heldout": {k: round(v, 4) for k, v in ev_held.items()},
        }
        evals[name] = ev_held

    rand_held = random_reward(env, eval_params, jax.random.key(99))
    entry = {
        "pipeline": "coverage BC, C++ VRP expert labels; or_default vs "
                    "last_accept descent-order probe (VERDICT r4 #4)",
        "world": "CoverageARL-v0, 8 real-facility sub-windows, R=4",
        "n_labeled_states": n,
        "label_flip_rate": round(flip, 4),
        "label_seconds": {"or_default": round(t_canon, 1),
                          "last_accept": round(t_probe, 1)},
        "models": results,
        "heldout_random_reward": round(rand_held, 2),
        "downstream_delta": {
            "heldout_reward_ratio_gap": round(
                abs(evals["or_default"]["reward_ratio"]
                    - evals["last_accept"]["reward_ratio"]), 4),
        },
    }
    merge_out(out, "bc_vrp", entry)


def run_dagger(out, n_iters=28, latent=64, rounds=6, n_grad_steps=32):
    from gym_flock_tpu.parallel.train_coverage import CoverageDaggerTrainer

    from gym_flock_tpu.models.gnn import EdgeGraphNet

    env, params, eval_params = coverage_world()
    trainer = CoverageDaggerTrainer(
        env, params, model=EdgeGraphNet(latent=latent, rounds=rounds),
        capacity=4096,
    )
    t0 = time.time()
    state, losses = trainer.fit(
        jax.random.key(0), n_iters=n_iters, n_envs=8, n_steps=16,
        n_grad_steps=n_grad_steps, batch_size=128,
    )
    dur = time.time() - t0
    pm = state["params"]
    inner = trainer.inner
    k_eval = jax.random.key(99)
    train_m = inner.evaluate(pm, k_eval, params, n_envs=64, n_steps=50)
    held_m = inner.evaluate(pm, k_eval, eval_params, n_envs=64, n_steps=50)
    rand_held = random_reward(env, eval_params, k_eval)
    entry = {
        "pipeline": "coverage DAGGER (mixture rollouts, rolling buffer)",
        "world": "CoverageARL-v0, 8 real-facility sub-windows, R=4",
        "model": {"latent": latent, "rounds": rounds},
        "train": {"n_iters": n_iters, "beta_decay": trainer.beta_decay,
                  "loss_first": round(losses[0], 4),
                  "loss_last": round(losses[-1], 4),
                  "seconds": round(dur, 1)},
        "train_bank": {k: round(v, 4) for k, v in train_m.items()},
        "heldout_bank": {**{k: round(v, 4) for k, v in held_m.items()},
                         "random_reward": round(rand_held, 2)},
    }
    merge_out(out, "dagger", entry)


def _flocking_episode_reward_fn(env, params, model, pm, n_steps=200, n_envs=64):
    """Shared closed-loop eval for the flocking BC and DAGGER pipelines —
    ONE definition so their numbers stay comparable."""

    @partial(jax.jit, static_argnames=("mode",))
    def episode_reward(key, mode: str):
        def one(key):
            k_reset, k_scan = jax.random.split(key)
            state, obs = env.reset_env(k_reset, params)

            def body(carry, key_t):
                state, obs = carry
                feats, adjm = obs
                if mode == "policy":
                    u = model.apply(pm, feats, adjm)
                elif mode == "expert":
                    u = env.expert(state, params)
                else:
                    u = jax.random.uniform(
                        key_t, (params.n_agents, 2), minval=-1.0, maxval=1.0
                    )
                state, obs, r, _, _ = env.step_env(key_t, state, u, params)
                return (state, obs), r

            _, rs = jax.lax.scan(
                body, (state, obs), jax.random.split(k_scan, n_steps)
            )
            return jnp.sum(rs)

        return jnp.mean(jax.vmap(one)(jax.random.split(key, n_envs)))

    return episode_reward


def run_flocking(out, n_iters=2500, k_hops=4, hidden=(128, 128), lr=1e-3):
    from gym_flock_tpu.models.gnn import AggregationGNN
    from gym_flock_tpu.parallel.train import (
        FlockingImitationTrainer, collect_flocking_batch)

    import optax

    env, params = gft.make("FlockingRelative-v0", n_agents=100)
    model = AggregationGNN(k_hops=k_hops, hidden=hidden)
    sched = optax.cosine_decay_schedule(lr, n_iters, alpha=0.03)
    trainer = FlockingImitationTrainer(env, params, model=model,
                                       learning_rate=sched)
    t0 = time.time()
    key = jax.random.key(0)
    carry = trainer.init(key)
    losses = []
    for it in range(n_iters):
        key, sub = jax.random.split(key)
        carry, loss = trainer.train_step(carry, sub, None, 8, 8)
        losses.append(float(loss))
    dur = time.time() - t0
    pm = carry[0]

    # held-out action MSE
    feats, adj, acts = collect_flocking_batch(
        env, params, jax.random.key(991), 16, 8)
    mse = float(trainer.loss_fn(pm, feats, adj, acts))
    base_mse = float(jnp.mean(acts ** 2))  # predict-zero baseline

    episode_reward = _flocking_episode_reward_fn(env, params, trainer.model, pm)

    k_eval = jax.random.key(99)
    pol = float(episode_reward(k_eval, "policy"))
    exp = float(episode_reward(k_eval, "expert"))
    rnd = float(episode_reward(k_eval, "random"))
    entry = {
        "pipeline": "flocking BC (AggregationGNN, Turner expert)",
        "world": "FlockingRelative-v0, N=100",
        "model": {"k_hops": k_hops, "hidden": list(hidden), "lr": lr},
        "train": {"n_iters": n_iters, "samples_per_iter": 64,
                  "loss_first": round(losses[0], 5),
                  "loss_last": round(float(np.mean(losses[-10:])), 5),
                  "seconds": round(dur, 1)},
        "heldout_action_mse": round(mse, 5),
        "predict_zero_mse": round(base_mse, 5),
        "episode_reward_200_steps": {
            "policy": round(pol, 1), "expert": round(exp, 1),
            "random": round(rnd, 1),
            "policy_vs_expert": round(pol / exp, 4) if exp else None,
        },
    }
    merge_out(out, "flocking", entry)


def run_flocking_dagger(out, n_iters=40, k_hops=4, hidden=(128, 128)):
    """Flocking DAGGER (parallel.dagger.DaggerTrainer) with the same
    AggregationGNN architecture as run_flocking — completes the
    BC-vs-DAGGER matrix across both trainable families."""
    from gym_flock_tpu.models.gnn import AggregationGNN
    from gym_flock_tpu.parallel.dagger import DaggerTrainer

    env, params = gft.make("FlockingRelative-v0", n_agents=100)
    model = AggregationGNN(k_hops=k_hops, hidden=hidden)
    trainer = DaggerTrainer(env, params, model=model, capacity=8192)
    t0 = time.time()
    state, losses = trainer.fit(
        jax.random.key(0), n_iters=n_iters, n_envs=8, n_steps=16,
        n_grad_steps=24,
    )
    dur = time.time() - t0
    pm = state.params

    episode_reward = _flocking_episode_reward_fn(env, params, trainer.model, pm)

    k_eval = jax.random.key(99)
    pol = float(episode_reward(k_eval, "policy"))
    exp = float(episode_reward(k_eval, "expert"))
    rnd = float(episode_reward(k_eval, "random"))
    entry = {
        "pipeline": "flocking DAGGER (AggregationGNN, Turner expert)",
        "world": "FlockingRelative-v0, N=100",
        "model": {"k_hops": k_hops, "hidden": list(hidden)},
        "train": {"n_iters": n_iters, "beta_decay": trainer.beta_decay,
                  "loss_first": round(losses[0], 5),
                  "loss_last": round(losses[-1], 5),
                  "seconds": round(dur, 1)},
        "episode_reward_200_steps": {
            "policy": round(pol, 1), "expert": round(exp, 1),
            "random": round(rnd, 1),
            "policy_vs_expert_cost": round(pol / exp, 4) if exp else None,
        },
    }
    merge_out(out, "flocking_dagger", entry)


def run_probe_vrp_speed(out):
    """Quick probe: seconds per VRP solve on the ARL bank."""
    from gym_flock_tpu.parallel.vrp_labels import vrp_label_states

    env, params, _ = coverage_world()
    batch, states = _collect_states(env, params, jax.random.key(0), 2, 4)
    states = {k: np.asarray(v) for k, v in states.items()}
    t0 = time.time()
    vrp_label_states(params, states, workers=2)
    dt = time.time() - t0
    print(f"{states['graph'].shape[0]} states in {dt:.1f}s "
          f"({dt / states['graph'].shape[0]:.2f} s/state, workers=2)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pipeline", choices=[
        "bc_greedy", "bc_vrp", "dagger", "flocking", "flocking_dagger",
        "probe_vrp_speed"])
    ap.add_argument("--out", default=OUT_DEFAULT)
    args = ap.parse_args()
    enable_compile_cache()
    {"bc_greedy": run_bc_greedy, "bc_vrp": run_bc_vrp,
     "dagger": run_dagger, "flocking": run_flocking,
     "flocking_dagger": run_flocking_dagger,
     "probe_vrp_speed": run_probe_vrp_speed}[args.pipeline](args.out)


if __name__ == "__main__":
    main()
