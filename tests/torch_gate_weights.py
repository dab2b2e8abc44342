"""The serving gates' weights: the JAX package's ``DecoderLM(vocab_size=64,
num_layers=1, num_heads=2, head_dim=8, max_positions=128).init_params(
PRNGKey(0))`` — the draw its gates (``fleet``/``migrate``/``control``/
``kv_cache`` ``main(["check"])`` and ``obs.cli.seeded_chaos``) serve —
kept as numpy in ``paddle_tpu_torch/serving/gate_weights.npz`` so the
port's gates replay the reference's traces without JAX.  The gates at
``max_positions=64`` take the first 64 rows of ``pos`` (the JAX draw's
rows there are the same).

Rewrite the file with ``python tests/torch_gate_weights.py``;
``tests/test_torch_fleet.py`` holds it equal to the JAX draw."""

import pathlib

import numpy as np

PATH = (pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch" /
        "serving" / "gate_weights.npz")


def jax_gate_weights(max_positions: int = 128):
    import jax

    from paddle_tpu.serving import DecoderLM

    model = DecoderLM(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
                      max_positions=max_positions)
    return {k: np.asarray(v) for k, v in
            model.init_params(jax.random.PRNGKey(0)).items()}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(PATH, **jax_gate_weights())
    print(f"wrote {PATH}")
