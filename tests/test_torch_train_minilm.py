"""The trainer at jax-minilm's width and depth on the CPU against the
reference: ``scripts/train_tiny_encoder.py``'s jitted step
(``jax.value_and_grad`` of its loss, ``optax.adam(2e-3)``) through the
reference's ``encode`` and the port's ``train_encoder.train``, from the
same parameters over the same seeded batches, at f32. Its own file, so
that its JAX compilation of a 6-layer step runs beside the smaller
parity tests (tests/test_torch_train_encoder.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from orama_core_tpu.models import encoder as jenc
from orama_core_tpu_torch.models import encoder as enc
from orama_core_tpu_torch.models import train_encoder as te
from test_torch_train_encoder import _loss_fn, _named_leaves


def test_minilm_width_follows_the_reference_into_its_collapse():
    """jax-minilm's width and depth (hidden 384, 6 layers, 12 heads, MLP
    1,536) at batch 16: 20 of the script's jitted steps against the
    port's ``train`` from the same parameters. At lr 2e-3 the reference
    collapses to uniform logits (loss ln 16) within two steps; the port's
    losses follow within relative 1e-5 and its parameters within the
    three-step test's quantiles. The largest difference is not bounded:
    after the collapse the gradients are rounding noise, which Adam turns
    into updates of up to lr."""
    n = len(te.build_vocab())
    cfg = te.train_config(n, hidden=enc.MINILM.hidden,
                          layers=enc.MINILM.layers, heads=enc.MINILM.heads)
    jcfg = jenc.EncoderConfig(
        vocab_size=n, hidden=cfg.hidden, layers=cfg.layers, heads=cfg.heads,
        mlp=cfg.mlp, max_len=64, out_dim=cfg.hidden, dtype=jnp.float32)
    assert cfg.mlp == enc.MINILM.mlp
    jp = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    start = jax.tree.map(np.asarray, jp)
    opt = optax.adam(2e-3)

    @jax.jit
    def step(p, s, *batch):
        loss, grads = jax.value_and_grad(_loss_fn(jcfg))(p, *batch)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    steps, batch, chance = 20, 16, float(np.log(16))
    rng = np.random.default_rng(0)
    tok = te.TrainTokenizer(te.build_vocab())
    p, s, want_losses = jp, opt.init(jp), []
    for _ in range(steps):
        data = te.sample_batch(rng, tok, batch, "cpu")
        p, s, loss = step(p, s, *(jnp.asarray(x.numpy()) for x in data))
        want_losses.append(float(loss))
    params, losses = te.train(cfg, steps, batch, seed=0, device="cpu",
                              params=start)
    print("reference", want_losses, "port", losses)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for traj in (want_losses, losses):
        assert traj[0] > chance + 0.5
        assert abs(np.mean(traj[-10:]) - chance) <= 1e-3, traj
    want = [w for _, w in _named_leaves(jax.tree.map(np.asarray, p))]
    diff = np.concatenate([np.abs(g.detach().numpy() - w).ravel()
                           for g, w in zip(te.leaves(params), want)]) / te.LR
    q999, q9999 = np.quantile(diff, [0.999, 0.9999])
    print(f"parameters in lr: q999 {q999}, q9999 {q9999}, max {diff.max()}")
    assert q999 <= 2e-3 and q9999 <= 0.05, (q999, q9999, diff.max())
