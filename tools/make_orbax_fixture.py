#!/usr/bin/env python3
"""Write the JAX-written orbax fixture of the port's tests and of ``chip_smoke.py`` phase 20.

    python3 tools/make_orbax_fixture.py [--out tests/data/orbax_small] [--seed 0]

This tool is not part of the port: it imports the JAX package and orbax, on a
machine that has them.  From one seed it builds a training state of the test
suite's small config (``tests/conftest.py::small_cfg``) in the tree of the JAX
package's ``create_train_state``: parameters and batchnorm statistics drawn
with numpy, Adam moments drawn on a coarse grid (so no leaf is all zeros: the
moments' zstd frames hold matches and FSE-coded sequences, the parameters'
Huffman-coded literals), step 3 and epoch 4.  It writes that state twice
under ``--out``:

* ``ckp_orbax/`` and ``ckp_orbax_manifest.json`` through the JAX package's
  ``save_checkpoint_orbax`` (orbax's OCDBT store, zstd level 1);
* ``ckp_state.npz`` and ``ckp_manifest.json`` through its ``save_checkpoint``,
  the npz then rewritten compressed (same members; ``np.load`` reads both);

and the config as ``cfg.json``.  The port reads the first and holds every
leaf to the second; ``tests/test_torch_orbax.py`` checks that this tool
rebuilds the fixture's leaves from its seed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 0
EPOCH = 4
STEP = 3


def small_config():
    """The test suite's ``small_cfg``."""
    from cvml_goalnet_tpu.config import AudioConfig, ModelConfig, PipelineConfig, PreprocessConfig, TrainConfig

    return PipelineConfig(
        preprocess=PreprocessConfig(skip_frames=30, frame_size=(24, 24)),
        audio=AudioConfig(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), text_vocab_size=128, text_embed_dim=16, text_num_layers=1,
                          text_num_heads=2, text_feature_dim=16, text_max_len=12, temporal_hidden=8),
        train=TrainConfig(num_epochs=2, subbatch_size=5, seed=7),
    )


def fixture_state(cfg, seed: int = SEED):
    """The JAX TrainState the fixture holds, rebuilt from ``seed``: the tree of the JAX package's
    ``create_train_state`` (its shapes, from ``jax.eval_shape``), every leaf drawn with numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cvml_goalnet_tpu.train.optim import AdamState
    from cvml_goalnet_tpu.train.state import TrainState, create_train_state

    shapes = jax.eval_shape(lambda: create_train_state(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def draw(fn):
        return lambda s: jnp.asarray(fn(s.shape).astype(np.float32))

    tree_map = jax.tree_util.tree_map
    params = tree_map(draw(lambda shape: rng.standard_normal(shape) * 0.1), shapes.params)
    model_state = tree_map(draw(lambda shape: rng.random(shape) + 0.5), shapes.model_state)
    mu = tree_map(draw(lambda shape: rng.integers(-8, 8, shape) * 2.0 ** -12), shapes.params)
    nu = tree_map(draw(lambda shape: rng.integers(0, 4, shape) * 2.0 ** -20), shapes.params)
    return TrainState(params=params, model_state=model_state,
                      opt_state=AdamState(step=jnp.asarray(STEP, dtype=jnp.int32), mu=mu, nu=nu), epoch=EPOCH)


def write(out: str, seed: int = SEED) -> None:
    import numpy as np

    from cvml_goalnet_tpu.train.checkpoint import save_checkpoint
    from cvml_goalnet_tpu.train.orbax_io import save_checkpoint_orbax

    cfg = small_config()
    state = fixture_state(cfg, seed)
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    cfg.save(os.path.join(out, "cfg.json"))
    save_checkpoint_orbax(out, state, cfg, tag="ckp")
    npz = save_checkpoint(out, state, cfg, tag="ckp")
    with np.load(npz) as data:
        members = {k: data[k] for k in data.files}
    np.savez_compressed(npz, **members)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join("tests", "data", "orbax_small"))
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    write(args.out, args.seed)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out} ({total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
