"""Convert the reference's real ARL occupancy maps into cached graph banks.

One-time tool: locates ``grid_slice10.npy`` (the map every reference
occupancy env uses — coverage_arl.py:19, coverage_full.py:3,
coverage_explore_full.py:3), builds each occupancy variant's device-ready
graph bank from it, and leaves the result in the content-keyed disk cache
(``$GYM_FLOCK_TPU_CACHE``, default ``<checkout>/.bank_cache``).  Every
subsequent ``gym_flock_tpu.make("CoverageARL-v0")`` etc. — in any process —
then loads the real world instantly instead of re-running the all-pairs
hop-cost preprocessing (tens of seconds for the full-facility variants).

Usage::

    python examples/convert_arl_map.py                 # all variants
    python examples/convert_arl_map.py --variants CoverageFull-v0
    python examples/convert_arl_map.py --maps-dir /path/with/grid_slice10.npy
    python examples/convert_arl_map.py --out banks/    # also export .npz

Map search order is documented in ``gym_flock_tpu/envs/maps.py``
($GYM_FLOCK_TPU_MAPS, installed gym_flock, $GYM_FLOCK_REFERENCE,
/root/reference).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

ALL_VARIANTS = [
    "CoverageARL-v0",
    "CoverageFull-v0",
    "ExploreEnv-v0",
    "ExploreFullEnv-v0",
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=ALL_VARIANTS,
                    help=f"env ids to convert (default: {' '.join(ALL_VARIANTS)})")
    ap.add_argument("--maps-dir", default=None,
                    help="directory containing grid_slice10.npy "
                         "(overrides auto-discovery)")
    ap.add_argument("--map", dest="map_path", default=None,
                    help="explicit path to an occupancy .npy")
    ap.add_argument("--out", default=None,
                    help="also export each bank as <out>/<env-id>.npz "
                         "(loadable via coverage_graph.load_graph_bank)")
    args = ap.parse_args(argv)

    import os

    if args.maps_dir:
        os.environ["GYM_FLOCK_TPU_MAPS"] = args.maps_dir

    import numpy as np

    import gym_flock_tpu as gft
    from gym_flock_tpu.envs.maps import find_reference_map

    map_path = args.map_path or find_reference_map(10)
    if map_path is None:
        print("No grid_slice10.npy found. Set $GYM_FLOCK_TPU_MAPS, "
              "$GYM_FLOCK_REFERENCE, or pass --maps-dir / --map.",
              file=sys.stderr)
        return 1
    print(f"map: {map_path}")
    from gym_flock_tpu.utils.cache import bank_cache_dir

    cache_dir = bank_cache_dir()
    print(f"bank cache: {cache_dir}")

    for env_id in args.variants:
        t0 = time.time()
        _, params = gft.make(env_id, real_map=map_path)
        bank = params.bank
        n_t = np.asarray(bank["n_targets"])
        print(
            f"{env_id}: {len(n_t)} graph(s), targets/graph "
            f"{n_t.min()}..{n_t.max()}, node budget {params.max_nodes} "
            f"({params.n_robots} robots), built+cached in "
            f"{time.time() - t0:.1f}s"
        )
        if args.out:
            from gym_flock_tpu.envs.coverage_graph import save_graph_bank

            os.makedirs(args.out, exist_ok=True)
            out = os.path.join(args.out, f"{env_id}.npz")
            save_graph_bank(out, bank)
            print(f"  exported {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
