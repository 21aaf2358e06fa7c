"""GNN policy models for imitation learning on swarm observations.

The reference ships no models — its envs feed an external learner through
two interfaces: the flocking ``(features [N,6], adjacency [N,N])`` tuple
(reference flocking_relative.py:109) and the padded GraphsTuple dict of the
coverage envs, decoded by the TensorFlow ``unpack_obs`` helper
(reference coverage.py:689-741).  This module provides both halves natively:

* :func:`unpack_obs` — JAX re-design of the TF helper: flat/batched dict obs
  -> statically-shaped masked graph (no boolean_mask; padding stays, a mask
  travels with the data, so shapes stay static);
* :class:`AggregationGNN` — the K-hop aggregation GNN used by the flocking
  papers (and mirrored by the reference's legacy in-env aggregation,
  old/flocking_multi.py:180-266): z_k = A^k X stacked over k, per-agent MLP;
* :class:`EdgeGraphNet` — message-passing network over the padded edge list
  for the coverage graphs, scoring each robot's action edges.

Each model is a frozen dataclass of hyperparameters with pure
``init(key, *inputs) -> params`` and ``apply(params, *inputs)`` methods over
a nested params dict; training lives in ``gym_flock_tpu.parallel.train``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

__all__ = [
    "unpack_obs",
    "unpack_obs_state",
    "AggregationGNN",
    "LargeAggregationGNN",
    "EdgeGraphNet",
]


def unpack_obs(
    obs: jax.Array,
    n_nodes: int,
    n_node_feat: int = 3,
    n_edge_feat: int = 1,
    max_edges_per_node: int = 4,
    n_glob_feat: int = 1,
):
    """Decode the flattened coverage observation into a masked graph batch.

    Mirror of reference coverage.py:689-741 (``unpack_obs``): the flat obs is
    the concatenation [nodes, edges, senders, receivers, step] (key order at
    coverage.py:90); senders == -1 marks padding.  Where the TF version
    boolean-masks edges into a ragged batch, this returns fixed-shape arrays
    plus an ``edge_mask`` — semantically identical under masked segment ops
    and shape-stable for jit.

    Args:
      obs: [B, flat_dim] batched flat observations.
    Returns:
      dict(nodes [B,N,nf], edges [B,E,ef], senders [B,E], receivers [B,E],
           edge_mask [B,E] bool, globs [B,G])
    """
    B = obs.shape[0]
    n = n_nodes
    e = n * max_edges_per_node
    import numpy as _np

    sizes = [n * n_node_feat, e * n_edge_feat, e, e, n_glob_feat]
    offsets = _np.cumsum([0] + sizes)  # static: slicing must not trace
    nodes = obs[:, offsets[0] : offsets[1]].reshape(B, n, n_node_feat)
    edges = obs[:, offsets[1] : offsets[2]].reshape(B, e, n_edge_feat)
    senders = obs[:, offsets[2] : offsets[3]].reshape(B, e).astype(jnp.int32)
    receivers = obs[:, offsets[3] : offsets[4]].reshape(B, e).astype(jnp.int32)
    globs = obs[:, offsets[4] : offsets[5]].reshape(B, n_glob_feat)
    edge_mask = senders != -1
    return {
        "nodes": nodes,
        "edges": edges,
        "senders": jnp.where(edge_mask, senders, 0),
        "receivers": jnp.where(edge_mask, receivers, 0),
        "edge_mask": edge_mask,
        "globs": globs,
    }


def unpack_obs_state(
    obs: jax.Array,
    state: jax.Array,
    n_nodes: int,
    dim_state: int,
    n_node_feat: int = 3,
    n_edge_feat: int = 1,
    max_edges_per_node: int = 4,
    n_glob_feat: int = 1,
):
    """State-augmented :func:`unpack_obs` (reference coverage.py:743-798,
    ``unpack_obs_state``) — the GraphsTuple decode the external RL learner
    uses when each node carries a pair of auxiliary state vectors (e.g. the
    pre/post-transition hidden state).

    ``state`` is [B, n_nodes * dim_state * 2] (or any shape reshapable to
    [B, n_nodes, 2*dim_state]); the reference splits it per node into two
    halves and concatenates each onto the node features, yielding two
    augmented node tables.  Returns the :func:`unpack_obs` dict with two
    extra entries:

      nodes1 [B, N, nf + dim_state] — nodes ++ state[..., :dim_state]
      nodes2 [B, N, nf + dim_state] — nodes ++ state[..., dim_state:]

    Masking semantics are identical to :func:`unpack_obs` (fixed shapes +
    ``edge_mask`` instead of TF boolean_mask).
    """
    g = unpack_obs(
        obs,
        n_nodes,
        n_node_feat=n_node_feat,
        n_edge_feat=n_edge_feat,
        max_edges_per_node=max_edges_per_node,
        n_glob_feat=n_glob_feat,
    )
    B = g["nodes"].shape[0]
    st = state.reshape(B, n_nodes, 2 * dim_state)
    g["nodes1"] = jnp.concatenate([g["nodes"], st[..., :dim_state]], axis=-1)
    g["nodes2"] = jnp.concatenate([g["nodes"], st[..., dim_state:]], axis=-1)
    return g


def _mlp_init(key, d_in: int, features: Sequence[int]):
    """Parameters of a ReLU MLP: ``{"Dense_i": {"kernel", "bias"}}`` with
    LeCun-normal kernels and zero biases."""
    dims = (d_in,) + tuple(features)
    keys = jax.random.split(key, len(features))
    init = jax.nn.initializers.lecun_normal()
    return {
        f"Dense_{i}": {
            "kernel": init(k, (dims[i], dims[i + 1]), jnp.float32),
            "bias": jnp.zeros((dims[i + 1],), jnp.float32),
        }
        for i, k in enumerate(keys)
    }


def _mlp_apply(p, x):
    n = len(p)
    for i in range(n):
        layer = p[f"Dense_{i}"]
        x = x @ layer["kernel"] + layer["bias"]
        if i + 1 < n:
            x = jax.nn.relu(x)
    return x


class _Model:
    """Pure model: ``init(key, *inputs) -> params`` and
    ``apply(params, *inputs)``; params are ``{"params": {"_MLP_i": ...}}``."""

    def clone(self, **changes):
        return dataclasses.replace(self, **changes)


def _khop_mlp_init(model, key, features):
    d_in = model.k_hops * features.shape[-1]
    mlp = _mlp_init(key, d_in, tuple(model.hidden) + (model.out_dim,))
    return {"params": {"_MLP_0": mlp}}


@dataclasses.dataclass(frozen=True)
class AggregationGNN(_Model):
    """K-hop aggregation GNN for flocking-style (features, adjacency) obs.

    z = [X, AX, A^2 X, ..., A^{K-1} X] concatenated per agent, followed by a
    shared per-agent MLP.  With the mean-pooled adjacency the reference
    returns as ``state_network``, A^k X is exactly the k-hop neighborhood
    average — the architecture of the flocking papers (README.md:47-58) and
    of the reference's legacy in-env aggregation (old/flocking_multi.py:180-266).
    """

    k_hops: int = 3
    hidden: Sequence[int] = (64, 64)
    out_dim: int = 2
    # The raw flocking features contain 1/r^2 and 1/r^4 channels whose
    # magnitude spans many decades (flocking_relative.py:124-125); arcsinh
    # squashes them to a trainable scale while staying odd and smooth.
    squash_inputs: bool = True

    def init(self, key, features: jax.Array, adjacency: jax.Array):
        return _khop_mlp_init(self, key, features)

    def apply(self, params, features: jax.Array, adjacency: jax.Array):
        if self.squash_inputs:
            features = jnp.arcsinh(features)
        zs = [features]
        z = features
        for _ in range(self.k_hops - 1):
            z = jnp.matmul(adjacency, z)
            zs.append(z)
        h = jnp.concatenate(zs, axis=-1)  # [N, K*F]
        return _mlp_apply(params["params"]["_MLP_0"], h)


@dataclasses.dataclass(frozen=True)
class LargeAggregationGNN(_Model):
    """AggregationGNN for swarms too large to materialize the adjacency.

    Same architecture as :class:`AggregationGNN`, but takes the raw agent
    state ``x [N, 4]`` instead of a dense ``[N, N]`` adjacency: the A^k X
    products run through ``ops.adjacency_matmul`` — the adjacency is built
    tile by tile from positions, O(N*F) memory, differentiable via its
    custom VJP — so the policy trains end-to-end at N where a dense A would
    be gigabytes (1 GB at N=16k).
    """

    k_hops: int = 3
    hidden: Sequence[int] = (64, 64)
    out_dim: int = 2
    comm_radius2: float = 0.81
    squash_inputs: bool = True
    # Override the aggregation, e.g. with the agent-axis-sharded
    # parallel.agent_shard.khop_aggregate_sharded inside shard_map (the
    # parameter tree is identical, so weights transfer between variants).
    aggregate_fn: Optional[Callable[[jax.Array, jax.Array], jax.Array]] = None

    def init(self, key, x: jax.Array, features: jax.Array):
        return _khop_mlp_init(self, key, features)

    def apply(self, params, x: jax.Array, features: jax.Array):
        from gym_flock_tpu.ops.pallas_flocking import khop_aggregate

        if self.squash_inputs:
            features = jnp.arcsinh(features)
        if self.aggregate_fn is not None:
            h = self.aggregate_fn(x, features)
        else:
            h = khop_aggregate(
                x, features, self.comm_radius2, self.k_hops, mean_pool=True
            )
        return _mlp_apply(params["params"]["_MLP_0"], h)


@dataclasses.dataclass(frozen=True)
class EdgeGraphNet(_Model):
    """Message-passing GNN over the padded coverage edge list.

    Rounds of: edge update from (edge_feat, sender_h, receiver_h) -> masked
    segment-sum into receivers -> node update.  Final per-edge logits are
    read off the robot action edges; the caller gathers each robot's
    ``n_actions`` candidate edges to form the policy logits.

    Static shapes throughout: padding edges carry zero messages via
    ``edge_mask`` instead of being filtered out.  Operates on a single
    (unbatched) graph — ``jax.vmap`` ``apply`` over a batch.

    MLP order in the params: node encoder, edge encoder, then per round the
    message and node-update MLPs, then the edge-logit head.
    """

    latent: int = 64
    rounds: int = 2

    def init(self, key, graph):
        lat = self.latent
        shapes = [
            (graph["nodes"].shape[-1], (lat,)),
            (graph["edges"].shape[-1], (lat,)),
        ]
        for _ in range(self.rounds):
            shapes += [(3 * lat, (lat, lat)), (2 * lat, (lat, lat))]
        shapes.append((lat, (lat, 1)))
        keys = jax.random.split(key, len(shapes))
        return {
            "params": {
                f"_MLP_{i}": _mlp_init(k, d_in, feats)
                for i, (k, (d_in, feats)) in enumerate(zip(keys, shapes))
            }
        }

    def apply(self, params, graph):
        p = params["params"]
        nodes, edges = graph["nodes"], graph["edges"]  # [N, nf], [E, ef]
        senders, receivers = graph["senders"], graph["receivers"]  # [E]
        mask = graph["edge_mask"][:, None].astype(nodes.dtype)  # [E, 1]
        n = nodes.shape[0]

        h = _mlp_apply(p["_MLP_0"], nodes)
        e_feat = _mlp_apply(p["_MLP_1"], edges)

        for r in range(self.rounds):
            msg_in = jnp.concatenate([e_feat, h[senders], h[receivers]], axis=-1)
            msg = _mlp_apply(p[f"_MLP_{2 + 2 * r}"], msg_in) * mask
            agg = jax.ops.segment_sum(msg, receivers, num_segments=n)
            h = _mlp_apply(
                p[f"_MLP_{3 + 2 * r}"], jnp.concatenate([h, agg], axis=-1)
            )
            e_feat = msg

        edge_logits = _mlp_apply(p[f"_MLP_{2 + 2 * self.rounds}"], e_feat)  # [E, 1]
        return h, edge_logits


def get_number_nodes(flat_dim: int, n_node_feat: int = 3, n_edge_feat: int = 1,
                     max_edges_per_node: int = 4, n_glob_feat: int = 1) -> int:
    """Node count from a flattened-obs dimension (reference coverage.py:675-680).

    Inverse of the flat layout: dim = n*(nf) + n*epn*(ef + 2) + glob.
    """
    return (flat_dim - n_glob_feat) // (
        max_edges_per_node * (2 + n_edge_feat) + n_node_feat
    )
