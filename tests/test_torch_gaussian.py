"""The port's Gaussian distribution against the JAX package's, on the CPU.

JAX's standard normals are drawn from its keys and injected (``noise=``),
so samples are comparable.  Every method runs on the same means, log
stds and actions under each option: plain, a fixed std with a sample clip
(DDPG), a fixed std with a noise clip and a sample clip (TD3's target
smoothing), log-std clamps with a tanh squash (SAC) and a minimum std
(the Gaussian PG agents).  Tolerance: rtol 1e-5, atol 1e-5, float32 (XLA
and torch round exp, log, tanh, atanh and softplus each their own way),
except the log-likelihood of a sample, whose absolute tolerance is 1e-5 of
its largest magnitude (log stds down to -20 put it near 60 a dimension).
Gradients of the SAC log-likelihood go through the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.distributions.gaussian import DistInfoStd as JaxDistInfoStd
from rlpyt_tpu.distributions.gaussian import Gaussian as JaxGaussian
from rlpyt_tpu_torch.distributions.gaussian import DistInfoStd, Gaussian

torch.set_num_threads(2)

CLOSE = dict(rtol=1e-5, atol=1e-5)
N, D = 64, 3
OPTIONS = {
    "plain": {},
    "ddpg": dict(std=0.1, clip=1.0),
    "td3_target": dict(std=0.2, noise_clip=0.5, clip=1.0),
    "sac": dict(squash=2.0, min_std=float(np.exp(-20.0)),
                max_std=float(np.exp(2.0))),
    "pg": dict(min_std=1e-6),
}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((N, D)).astype(np.float32)
    # Log stds across the clamps: some below -20 and above 2.
    log_std = rng.uniform(-25.0, 4.0, (N, D)).astype(np.float32)
    return mean, log_std


def both(mean, log_std):
    return (JaxDistInfoStd(jnp.asarray(mean), jnp.asarray(log_std)),
            DistInfoStd(torch.tensor(mean), torch.tensor(log_std)))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **CLOSE)


@pytest.mark.parametrize("option", OPTIONS)
def test_sample_with_jax_noise_matches_jax(option):
    kw = OPTIONS[option]
    jdist, dist = JaxGaussian(D, **kw), Gaussian(D, **kw)
    mean, log_std = inputs(1)
    mean *= 3.0   # so the clips bind
    jinfo, info = both(mean, log_std)
    key = jax.random.key(5)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (N, D))))
    close(dist.sample(info, noise=noise), jdist.sample(key, jinfo))
    a, logp = dist.sample_with_log_prob(info, noise=noise)
    ja, jlogp = jdist.sample_with_log_prob(key, jinfo)
    close(a, ja)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jlogp)).max())


@pytest.mark.parametrize("option", OPTIONS)
def test_densities_match_jax(option):
    """log_likelihood, likelihood_ratio, kl, entropy, perplexity, and the
    means with and without a valid mask."""
    kw = OPTIONS[option]
    jdist, dist = JaxGaussian(D, **kw), Gaussian(D, **kw)
    # Stds in [e^-1, e^0.5], so that the likelihood ratio stays finite.
    mean, log_std = inputs(2)
    log_std = np.clip(log_std, -1.0, 0.5)
    mean2, log_std2 = inputs(3)
    log_std2 = np.clip(log_std2, -1.0, 0.5)
    jold, old = both(mean, log_std)
    jnew, new = both(mean2, log_std2)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.5, 1.5, (N, D)).astype(np.float32)
    valid = (rng.random(N) < 0.7).astype(np.float32)
    close(dist.log_likelihood(torch.tensor(x), new),
          jdist.log_likelihood(jnp.asarray(x), jnew))
    close(dist.likelihood_ratio(torch.tensor(x), old, new),
          jdist.likelihood_ratio(jnp.asarray(x), jold, jnew))
    close(dist.kl(old, new), jdist.kl(jold, jnew))
    close(dist.entropy(new), jdist.entropy(jnew))
    close(dist.perplexity(new), jdist.perplexity(jnew))
    for v in (None, valid):
        tv, jv = ((None, None) if v is None
                  else (torch.tensor(v), jnp.asarray(v)))
        close(dist.mean_kl(old, new, tv), jdist.mean_kl(jold, jnew, jv))
        close(dist.mean_entropy(new, tv), jdist.mean_entropy(jnew, jv))


def test_sac_log_prob_grads_match_jax():
    """d/d(mean, log_std) of the squashed sample's log pi and of the
    action, the SAC losses' path, against jax.grad."""
    kw = OPTIONS["sac"]
    jdist, dist = JaxGaussian(D, **kw), Gaussian(D, **kw)
    mean, log_std = inputs(6)
    log_std = np.clip(log_std, -3.0, 1.0)
    key = jax.random.key(7)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (N, D))))

    def jax_obj(m, s):
        a, logp = jdist.sample_with_log_prob(key, JaxDistInfoStd(m, s))
        return jnp.sum(logp) + jnp.sum(a ** 2)

    jgm, jgs = jax.grad(jax_obj, argnums=(0, 1))(jnp.asarray(mean),
                                                 jnp.asarray(log_std))
    m = torch.tensor(mean, requires_grad=True)
    s = torch.tensor(log_std, requires_grad=True)
    a, logp = dist.sample_with_log_prob(DistInfoStd(m, s), noise=noise)
    (logp.sum() + (a ** 2).sum()).backward()
    close(m.grad, jgm)
    close(s.grad, jgs)


def test_sample_draws_from_the_generator():
    """Without injected noise the draws come from the generator: the same
    seed gives the same sample, and the samples have the set std."""
    dist = Gaussian(D, std=0.5)
    info = DistInfoStd(torch.zeros(20_000, D), torch.zeros(20_000, D))
    a = dist.sample(info, torch.Generator().manual_seed(3))
    b = dist.sample(info, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 0.5) < 0.01
