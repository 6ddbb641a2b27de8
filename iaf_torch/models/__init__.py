"""The two model families (``iaf_tpu/models/__init__.py``): the CIFAR
conv-latent IAF ResNet VAE (``cvae``) and the MNIST vector-latent
dense-MADE IAF VAE (``mnist_vae``).

Each family module exposes the same names: ``Model`` (its ``nn.Module``),
``init_params(cfg, batch, rng, model=None, device, noise=None)``,
``apply_fn(cfg, model, rng, x, mode, k, noise=None)`` returning a
NamedTuple with at least (loss, elbo_nats, kl_obj, kl_cost, log_pxz,
log_w), ``noise_shapes(cfg, rows)`` and ``draw_noise(cfg, rng, out)``
(a training forward's noise sites and draws), ``pixels(out)`` (the
reconstructions in [0, 255]) and ``sample(cfg, model, rng, num,
temperature)``.
"""

from iaf_torch.core.config import Config


def get_model(cfg: Config):
    """The family module of ``cfg``: bernoulli -> ``mnist_vae``, else
    ``cvae``."""
    if cfg.likelihood == "bernoulli":
        from iaf_torch.models import mnist_vae
        return mnist_vae
    from iaf_torch.models import cvae
    return cvae
