"""The port's ``loss_fn`` and the gradient of every parameter against
``jax.grad`` of the reference's, on the CPU, at smoke widths: every one of
the 10 archs as the reference's tests/test_models.py trains them, in
float32 compute; granite-3-8b in bf16 compute; and per-layer remat.

Weights come from the port's ``init_params`` and cross to the reference as
numpy arrays (bf16 by bits); batches come from numpy seeds.  Tolerances:

* float32 compute: the loss and its CE within 1e-5 relative, the aux loss
  within 1e-5 relative (or 1e-7 absolute); every gradient within 1e-4 of
  that leaf's largest reference gradient, except a leaf held in bf16
  (jamba's and arctic's masters), whose gradient is a bf16 tensor: there
  the bound is 2**-8 of the leaf's largest gradient, one bf16 ulp, since
  a float32 cotangent a few ulps off rounds to a neighbouring bf16 value;
* bf16 compute: 5e-2 relative for the loss and each leaf's gradient.

The reference side of each case is computed once per module (its
compiles are the cost).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

# the architectures the reference holds (the port adds its own beside them)
CASES = ([(a, "float32", False) for a in ref_list_archs()]
         + [("granite-3-8b", "bfloat16", False),
            ("granite-3-8b", "float32", True),
            ("mixtral-8x7b", "float32", True)])
BF16_ULP = 2.0 ** -8


def _batch(cfg, B, T, seed):
    """As the reference's tests/test_models.py trains each arch, with a
    few masked labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        out["embeds"] = rng.normal(0, 1, (B, T, cfg.frontend_dim)).astype(
            np.float32)
        if cfg.rope_kind == "mrope":
            out["positions"] = np.broadcast_to(
                np.arange(T)[None, :, None], (B, T, 3)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[0, -3:] = -1
    out["labels"] = labels
    return out


def _cfgs(arch, dt, remat):
    return (dataclasses.replace(get_config(arch, True), dtype=dt,
                                remat=remat),
            dataclasses.replace(ref_get_config(arch, True), dtype=dt,
                                remat=remat))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch, dt, remat):
        key = (arch, dt, remat)
        if key not in cache:
            cfg, rcfg = _cfgs(arch, dt, remat)
            model = M.init_params(cfg, seed=3, device="cpu")
            params = jax.tree.map(
                lambda a: jnp.asarray(a.view(jnp.bfloat16)
                                      if a.dtype == np.uint16 else a),
                params_to_numpy(model))
            batch = {k: jnp.asarray(v) for k, v in
                     _batch(rcfg, 2, 32, seed=4).items()}
            (loss, (ce, aux)), g = jax.jit(jax.value_and_grad(
                lambda p: RM.loss_fn(rcfg, p, batch), has_aux=True))(params)
            named = {"_".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): np.asarray(leaf)
                     for path, leaf in
                     jax.tree_util.tree_flatten_with_path(g)[0]}
            cache[key] = (model, float(loss), float(ce), float(aux), named)
        return cache[key]
    return get


@pytest.mark.parametrize("arch,dt,remat", CASES)
def test_loss_and_every_gradient_match_jax_grad(arch, dt, remat, reference):
    cfg, _ = _cfgs(arch, dt, remat)
    model, rloss, rce, raux, rgrads = reference(arch, dt, remat)
    model.requires_grad_()
    batch = {k: torch.as_tensor(v) for k, v in
             _batch(cfg, 2, 32, seed=4).items()}
    loss, (ce, aux) = M.loss_fn(cfg, model, batch)
    named = {"_".join(map(str, p)): t for p, t in leaves_with_paths(model)}
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    tol = 1e-5 if dt == "float32" else 5e-2
    assert abs(loss.item() - rloss) <= tol * abs(rloss)
    assert abs(ce.item() - rce) <= tol * abs(rce)
    assert abs(aux.item() - raux) <= max(tol * abs(raux), 1e-7)
    assert sorted(named) == sorted(rgrads)
    for (name, p), g in zip(named.items(), grads):
        want = _f32(rgrads[name])
        got = (np.zeros(p.shape, np.float32) if g is None
               else g.detach().float().numpy())
        assert got.shape == want.shape, name
        if dt == "bfloat16":
            gtol = 5e-2
        else:
            gtol = BF16_ULP if p.dtype == torch.bfloat16 else 1e-4
        err = float(np.abs(got - want).max())
        assert err <= gtol * float(np.abs(want).max()), (name, err)
