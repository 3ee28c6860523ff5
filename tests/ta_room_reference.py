"""The JAX package's translation averaging on chip_smoke.ta_room_inputs()
(Room-454's pair graph, 9,252 pairs), on the host's CPU: per method the
camera-centre error after a similarity, the bound base of phase 12 (b) of
chip_smoke.py (TA_METHOD_REF), and the time.

    python tests/ta_room_reference.py [method ...]     (default: chordal lud bata l1)

The JAX solver's Jacobian chunking is turned off (obs_chunk=None,
jac_chunk=None): above 8192 rows its chunked pass calls the deleted
_chunk_arrays (ROADMAP F1); unchunked it computes the same sums.
"""

import functools
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main(methods):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import chip_smoke
    from panovlm_tpu.models import translation_averaging as ta
    ta.LMOptions = functools.partial(ta.LMOptions, obs_chunk=None, jac_chunk=None)
    kwargs, C, R_cw = chip_smoke.ta_room_inputs()
    for method in methods:
        t0 = time.time()
        t, _ = ta.translation_averaging(**kwargs, method=method)
        err = chip_smoke._similarity_error(-np.einsum("nji,nj->ni", R_cw, t), C)
        print(f"{method}: camera-centre error after a similarity {err:.5f} m "
              f"({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["chordal", "lud", "bata", "l1"])
