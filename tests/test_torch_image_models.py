"""The port's image models, their convolution helpers and the image
transformers against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function and
the port's.  Tolerances: each model's outputs, loss and every gradient
from the same flax weights within 1e-5 of max(1, |ref|) (float32 sums in
another order); the per-step losses of a short ``fit`` within rtol 1e-4;
the convolution and pooling helpers within 1e-5; the image transformers
and ``ImageDataset`` equal.  Each place where torch's default differs
from flax's (XLA's SAME padding at stride 2, the transposed convolution's
kernel flip, LayerNorm's epsilon 1e-6, the tanh GELU, the nearest-pixel
resize at half-pixel centres) has a case that holds the port to flax and
shows that torch's default misses it.  Sizes are small: a few filters,
16-32 pixel images.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from deepchem_tpu.data import ImageDataset as JaxImageDataset
from deepchem_tpu.data import NumpyDataset as JaxNumpyDataset
from deepchem_tpu.models.chemnet import ChemCeption as JaxChemCeption
from deepchem_tpu.models.cnn import CNN as JaxCNN
from deepchem_tpu.models.jax_model import _flatten_params
from deepchem_tpu.models.oneformer import OneFormer as JaxOneFormer
from deepchem_tpu.models.unet import InceptionV3Model as JaxInceptionV3
from deepchem_tpu.models.unet import UNetModel as JaxUNet
from deepchem_tpu.trans import transformers as jax_trans
from deepchem_tpu_torch.data import ImageDataset, NumpyDataset
from deepchem_tpu_torch.models import (CNN, ChemCeption, Conv, ConvTranspose,
                                       InceptionV3Model, OneFormer, UNetModel,
                                       params_from_flax)
from deepchem_tpu_torch.models.conv_layers import avg_pool, max_pool
from deepchem_tpu_torch.models.convert import flax_state
from deepchem_tpu_torch.models.oneformer import (gelu, layer_norm,
                                                 resize_nearest)
from deepchem_tpu_torch.trans import (DataTransforms, ImageTransformer,
                                      pil_resize)

torch.set_num_threads(1)


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _load_layer(layer, variables):
    """One flax layer's parameters into the port's, by the layer's own
    layout conversion (``flax_tensor``, as ``params_from_flax`` uses it)."""
    p = variables['params']
    layer.load_state_dict({'weight': layer.flax_tensor('weight',
                                                       p['kernel']),
                           'bias': layer.flax_tensor('bias', p['bias'])})


def _layer_params(kernel_shape, seed):
    rng = np.random.RandomState(seed)
    fan_in = np.prod(kernel_shape[:-1])
    return {'params': {
        'kernel': (rng.randn(*kernel_shape) / np.sqrt(fan_in)).astype(
            np.float32),
        'bias': (rng.randn(kernel_shape[-1]) * 0.1).astype(np.float32)}}


def _flax_layer(m, p, x, g):
    """The flax layer's output and input gradient for the cotangent ``g``,
    one compiled function."""
    def run(v, ct):
        out, vjp = jax.vjp(lambda u: m.apply(p, u), v)
        return out, vjp(ct)[0]
    return [np.asarray(a) for a in jax.jit(run)(jnp.asarray(x),
                                                jnp.asarray(g))]


# -------------------------------------------------- convolution helpers

# (dims, kernel, stride, size): odd and even sizes, stride 1 and 2, even
# kernels
CONVS = [(1, 3, 1, 9), (1, 4, 2, 10), (1, 20, 1, 12), (2, 3, 2, 32),
         (2, 4, 2, 80), (2, 3, 2, 33), (2, 2, 1, 7), (3, 3, 2, 6)]


@pytest.mark.parametrize('dims,k,s,n', CONVS)
def test_conv_same_matches_flax(dims, k, s, n):
    """flax ``nn.Conv`` (SAME by default) forward and input gradient."""
    rng = np.random.RandomState(dims * 100 + k * 10 + s)
    x = rng.randn(2, *(n,) * dims, 3).astype(np.float32)
    m = fnn.Conv(5, (k,) * dims, strides=(s,) * dims)
    p = _layer_params((k,) * dims + (3, 5), 0)
    ours = Conv(3, 5, (k,) * dims, s)
    _load_layer(ours, p)
    xt = _nchw(x).requires_grad_()
    out = ours(xt)
    g = rng.randn(*_nhwc(out).shape).astype(np.float32)
    out.backward(_nchw(g))
    ref, ref_dx = _flax_layer(m, p, x, g)
    assert _scaled(_nhwc(out), ref) <= 1e-5
    assert _scaled(_nhwc(xt.grad), ref_dx) <= 1e-5


def test_torch_symmetric_padding_misses_xla_same_at_stride_2():
    """At stride 2 over an even size XLA pads 0 before and 1 after (k 3,
    n 32); torch's symmetric ``padding=k // 2`` shifts every output."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    m = fnn.Conv(4, (3, 3), strides=(2, 2))
    p = _layer_params((3, 3, 3, 4), 1)
    ref = np.asarray(jax.jit(m.apply)(p, jnp.asarray(x)))
    ours = Conv(3, 4, (3, 3), 2)
    _load_layer(ours, p)
    with torch.no_grad():
        sym = F.conv2d(_nchw(x), ours.weight, ours.bias, 2, 1)
        same = ours(_nchw(x))
    assert _scaled(_nhwc(same), ref) <= 1e-5
    assert _scaled(_nhwc(sym), ref) > 0.1


@pytest.mark.parametrize('k,s,n', [(2, 2, 4), (2, 2, 5), (3, 2, 4),
                                   (3, 1, 5), (4, 2, 3)])
def test_conv_transpose_matches_flax(k, s, n):
    """flax ``nn.ConvTranspose`` (SAME, kernel not transposed): the port
    flips the kernel; torch's unflipped ``conv_transpose`` misses it."""
    rng = np.random.RandomState(k * 10 + n)
    x = rng.randn(2, n, n, 3).astype(np.float32)
    m = fnn.ConvTranspose(4, (k, k), strides=(s, s))
    p = _layer_params((k, k, 3, 4), 2)
    ours = ConvTranspose(3, 4, (k, k), (s, s))
    _load_layer(ours, p)
    xt = _nchw(x).requires_grad_()
    out = ours(xt)
    g = rng.randn(*_nhwc(out).shape).astype(np.float32)
    out.backward(_nchw(g))
    ref, ref_dx = _flax_layer(m, p, x, g)
    assert out.shape[2:] == ref.shape[1:3]
    assert _scaled(_nhwc(out), ref) <= 1e-5
    assert _scaled(_nhwc(xt.grad), ref_dx) <= 1e-5
    if (k, s) == (2, 2):               # UNet's: torch's layout unflipped
        kern = np.asarray(p['params']['kernel'])
        unflipped = torch.from_numpy(kern.transpose(2, 3, 0, 1).copy())
        with torch.no_grad():
            plain = F.conv_transpose2d(_nchw(x), unflipped, ours.bias, s)
        assert _scaled(_nhwc(plain), ref) > 0.1


@pytest.mark.parametrize('kind,window,stride,padding,n', [
    ('max', 2, 2, 'VALID', 9), ('max', 3, 2, 'VALID', 16),
    ('avg', 2, 2, 'VALID', 8), ('avg', 3, 1, 'SAME', 7),
    ('avg', 2, 2, 'SAME', 7), ('max', 3, 2, 'SAME', 8)])
def test_pooling_matches_flax(kind, window, stride, padding, n):
    """``max_pool`` and ``avg_pool`` (a SAME pad's zeros counted)."""
    x = np.random.RandomState(n).randn(2, n, n, 3).astype(np.float32)
    fn = fnn.max_pool if kind == 'max' else fnn.avg_pool
    ref = np.asarray(fn(jnp.asarray(x), (window, window), (stride, stride),
                        padding))
    ours = (max_pool if kind == 'max' else avg_pool)(
        _nchw(x), (window, window), (stride, stride), padding)
    assert _scaled(_nhwc(ours), ref) <= 1e-6


def test_flax_defaults_layer_norm_gelu_and_nearest_resize():
    """The port's LayerNorm epsilon (1e-6), GELU (tanh) and nearest
    resize (half-pixel centres, down and up) equal flax's and JAX's;
    torch's defaults (1e-5, erf, 'nearest') do not."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 16) * 3e-3).astype(np.float32)    # variance ~1e-5
    ln = fnn.LayerNorm()
    ref = np.asarray(ln.apply({'params': {'scale': np.ones(16, np.float32),
                                          'bias': np.zeros(16, np.float32)}},
                              jnp.asarray(x)))
    ours = layer_norm(16)
    with torch.no_grad():
        assert _scaled(ours(torch.from_numpy(x)).numpy(), ref) <= 1e-5
        assert _scaled(torch.nn.LayerNorm(16)(torch.from_numpy(x)).numpy(),
                       ref) > 1e-2
    v = np.linspace(-4, 4, 81).astype(np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(v)))
    assert np.abs(gelu(torch.from_numpy(v)).numpy() - ref).max() <= 1e-6
    assert np.abs(F.gelu(torch.from_numpy(v)).numpy() - ref).max() > 1e-4
    for src, dst in ((30, 8), (2, 3), (16, 32), (7, 4)):
        img = rng.randn(1, src, src, 2).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(img),
                                          (1, dst, dst, 2), 'nearest'))
        ours = _nhwc(resize_nearest(_nchw(img), (dst, dst)))
        np.testing.assert_array_equal(ours, ref)
        if (src, dst) in ((30, 8), (2, 3)):
            plain = _nhwc(F.interpolate(_nchw(img), (dst, dst)))
            assert np.abs(plain - ref).max() > 0.5


# ------------------------------------------------------------- models

def _images(n, size, channels, scale=1.0, seed=0):
    return (np.random.RandomState(seed).rand(n, size, size, channels)
            * scale).astype(np.float32)


def _labels(n, n_tasks, kind, seed=1):
    rng = np.random.RandomState(seed)
    if kind == 'classification':
        return (rng.rand(n, n_tasks) > 0.5).astype(np.float32)
    return rng.randn(n, n_tasks).astype(np.float32)


# name: (port class, JAX class, arguments of both, X, y)
def _cases():
    img16 = _images(6, 16, 1)
    return {
        'chemception': (ChemCeption, JaxChemCeption,
                        dict(base_filters=4, n_tasks=2), img16,
                        _labels(6, 2, 'regression')),
        'chemception_cls': (ChemCeption, JaxChemCeption,
                            dict(base_filters=4, n_tasks=2,
                                 mode='classification'), img16[..., 0],
                            _labels(6, 2, 'classification')),
        'cnn1d': (CNN, JaxCNN, dict(n_tasks=2, n_features=5, dims=1,
                                    layer_filters=(4, 4), kernel_size=4,
                                    dense_layer_size=8, dropouts=0.0),
                  np.random.RandomState(2).rand(6, 12, 5).astype(
                      np.float32), _labels(6, 2, 'classification')),
        'cnn2d_residual': (CNN, JaxCNN,
                           dict(n_tasks=1, n_features=3, dims=2,
                                layer_filters=(3, 3), kernel_size=3,
                                dense_layer_size=6, dropouts=0.0,
                                residual=True, pool_type='average',
                                mode='regression'),
                           _images(6, 9, 3), _labels(6, 1, 'regression')),
        'cnn3d': (CNN, JaxCNN, dict(n_tasks=1, n_features=1, dims=3,
                                    layer_filters=(3,), kernel_size=2,
                                    dense_layer_size=4, dropouts=0.0,
                                    mode='regression'),
                  np.random.RandomState(3).rand(6, 5, 6, 4).astype(
                      np.float32), _labels(6, 1, 'regression')),
        'unet': (UNetModel, JaxUNet, dict(in_channels=2), _images(4, 16, 2),
                 (np.random.RandomState(4).rand(4, 16, 16, 1) > 0.5).astype(
                     np.float32)),
        'inception': (InceptionV3Model, JaxInceptionV3, dict(n_tasks=2),
                      _images(4, 32, 3), _labels(4, 2, 'classification')),
        'oneformer': (OneFormer, JaxOneFormer,
                      dict(hidden=16, dec_layers=1, num_queries=4),
                      _images(4, 32, 3, 255.0),
                      np.random.RandomState(5).randint(0, 2, (4, 32, 32))),
    }


CASES = _cases()


def flax_tree(module, inputs, seed=0):
    """A parameter tree of the flax ``module`` for ``inputs``, its
    structure and shapes from ``jax.eval_shape`` (nothing compiled), its
    values drawn with numpy: kernels normal over the square root of their
    fan-in, biases and other leaves normal at 0.1, LayerNorm scales about
    1, embeddings normal over the square root of their width."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in inputs],
        training=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.randn(*shape)
        if name == 'kernel':
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif name == 'embedding':
            z = z / np.sqrt(shape[-1])
        elif name == 'scale':
            z = 1 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)
    return {'params': jax.tree_util.tree_map_with_path(
        draw, shapes['params'])}


def held_to_jax(ref, ours, batch, dataset, steps=3, lr=0.003,
                eps_steps=None):
    """From the flax tree in ``ref.params`` (loaded into ``ours``): the
    JAX module's outputs, loss and every gradient on ``batch`` (arrays of
    ``ref.default_generator``) by one jitted function, and its losses over
    ``steps`` steps on that batch under Adam written in numpy (optax's
    formula), against the port's eval outputs (1e-5 of max(1, |ref|)),
    step-1 loss (rtol 1e-5) and gradients (1e-5 of max(1, |g|)), and its
    ``fit`` of ``steps`` epochs of ``dataset`` (the batch's rows; rtol
    1e-4).  A variational model's draws are ``eps_steps``, one a step:
    the JAX module's ``jax.random.normal`` returns them."""
    j_in, j_lab, j_w = ([jnp.asarray(a) for a in part] for part in batch)

    def loss_fn(p, eps):
        if eps is None:
            out = ref.module.apply(p, *j_in, training=False)
        else:
            normal = jax.random.normal
            jax.random.normal = lambda key, shape: eps
            try:
                out = ref.module.apply(p, *j_in, training=True, rngs={
                    'dropout': jax.random.PRNGKey(0)})
            finally:
                jax.random.normal = normal
        out = _as_list(out)
        return ref._compute_loss(out, j_lab, j_w), out
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    p = jax.tree.map(np.asarray, ref.params)
    mu = jax.tree.map(np.zeros_like, p)
    nu = jax.tree.map(np.zeros_like, p)
    ref_losses = []
    for t in range(1, steps + 1):
        (loss, o), g = step(p, None if eps_steps is None
                            else jnp.asarray(eps_steps[t - 1]))
        g = jax.tree.map(np.asarray, g)
        ref_losses.append(float(loss))
        if t == 1:
            ref_out, g_ref = o, g
        mu = jax.tree.map(lambda m, d: 0.9 * m + 0.1 * d, mu, g)
        nu = jax.tree.map(lambda v, d: 0.999 * v + 0.001 * d * d, nu, g)
        p = jax.tree.map(
            lambda w, m, v: w - lr * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8), p, mu, nu)
    assert sum(t.numel() for t in ours.module.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(ref.params))
    t_in, t_lab, t_w = ours._prepare_batch(tuple(
        [np.asarray(a) for a in part] for part in batch))
    t_eps = {} if eps_steps is None else {
        'eps': torch.from_numpy(np.asarray(eps_steps[0]))}
    ours.module.eval()
    with torch.no_grad():
        out = _as_list(ours.module(*t_in, **t_eps))
    assert len(out) == len(ref_out)
    for a, b in zip(out, ref_out):
        assert a.shape == b.shape
        assert _scaled(a.numpy(), b) <= 1e-5
    ours.module.train()
    value = ours._compute_loss(_as_list(ours.module(*t_in, **t_eps)),
                               t_lab, t_w)
    value.backward()
    np.testing.assert_allclose(value.item(), ref_losses[0], rtol=1e-5)
    grads = dict(ours.module.named_parameters())
    want = flax_state(_flatten_params(g_ref), ours.module)
    assert set(want) == set(grads)
    for key, g in want.items():
        assert _scaled(grads[key].grad.numpy(), g.numpy()) <= 1e-5, key
    losses = []
    ours.fit(dataset, nb_epoch=steps, checkpoint_interval=0,
             deterministic=True, all_losses=losses)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def _as_list(out):
    return out if isinstance(out, (list, tuple)) else [out]


def _pair(name, **kw):
    """A JAX model and a port model with the same flax parameters, and
    the JAX model's first batch."""
    model, ref_model, args, X, y = CASES[name]
    args = dict(args, batch_size=4, learning_rate=0.003, log_frequency=1,
                **kw)
    ref = ref_model(**args)
    ds, ds_ref = _datasets(name)
    batch = next(ref.default_generator(ds_ref, deterministic=True))
    ref.params = flax_tree(ref.module, batch[0])
    port_args = dict(args, device='cpu')
    if name == 'oneformer':
        port_args['image_size'] = X.shape[1:3]
    ours = model(**port_args)
    params_from_flax(_flatten_params(ref.params), ours.module)
    return ref, ours, batch


def _datasets(name):
    _, _, _, X, y = CASES[name]
    w = np.ones(y.shape[:2], np.float32) if y.ndim > 1 else None
    return NumpyDataset(X, y, w), JaxNumpyDataset(X, y, w)


@pytest.mark.parametrize('name', sorted(CASES))
def test_image_model_matches_jax(name):
    """A batch of 4 from the same flax weights: parameter count and tree,
    outputs, loss, every gradient, and 3 Adam steps (:func:`held_to_jax`);
    then ``predict`` over the whole dataset (batches of 4, the last
    padded) against the module's own outputs (OneFormer: the label maps,
    the composed map brought to full size by nearest neighbour)."""
    ref, ours, batch = _pair(name)
    ds, _ = _datasets(name)
    held_to_jax(ref, ours, batch, NumpyDataset(ds.X[:4], ds.y[:4],
                                               ds.w[:4]))
    pred = ours.predict(ds)
    with torch.no_grad():
        out = _as_list(ours.module.eval()(torch.from_numpy(ds.X)))[0]
    if name == 'oneformer':
        full = resize_nearest(out.permute(0, 3, 1, 2), ds.X.shape[1:3])
        np.testing.assert_array_equal(pred, full.argmax(dim=1).numpy())
        assert pred.shape == ds.X.shape[:3]
    else:
        assert _scaled(pred, out.numpy()) <= 1e-5


def test_cnn_dropout_and_uncertainty():
    """CNN's dropout masks come from a host generator seeded with the
    model's seed: two models of one seed train alike, eval outputs are
    deterministic; the uncertainty head's eval outputs (values, variance,
    log variance) from the same weights within 1e-5 of JAX's."""
    X = CASES['cnn1d'][3]
    y = _labels(len(X), 2, 'regression')
    kw = dict(n_tasks=2, n_features=5, dims=1, layer_filters=(4,),
              kernel_size=3, dense_layer_size=8, dropouts=0.5,
              mode='regression', uncertainty=True, batch_size=3)
    ref = JaxCNN(**kw)
    ref.params = flax_tree(ref.module, [X[:3]])
    ours = CNN(device='cpu', **kw)
    params_from_flax(_flatten_params(ref.params), ours.module)
    ref_out = jax.jit(lambda p, x: ref.module.apply(p, x, training=False))(
        ref.params, jnp.asarray(X[:3]))
    with torch.no_grad():
        out = ours.module.eval()(torch.from_numpy(X[:3]))
    for a, b in zip(out, ref_out):
        assert _scaled(a.numpy(), b) <= 1e-5
    runs = []
    for _ in range(2):
        m = CNN(device='cpu', **kw)
        losses = []
        m.fit(NumpyDataset(X, y), nb_epoch=2, checkpoint_interval=0,
              all_losses=losses)
        runs.append(losses)
    assert runs[0] == runs[1]
    with pytest.raises(ValueError):
        CNN(device='cpu', **dict(kw, dropouts=0.0))


# ------------------------------------------------ image transformers

def _uint8_images():
    rng = np.random.RandomState(7)
    return {'L': rng.randint(0, 256, (23, 37)).astype(np.uint8),
            'RGB': rng.randint(0, 256, (30, 20, 3)).astype(np.uint8)}


@pytest.mark.parametrize('mode', ['L', 'RGB'])
def test_image_transformer_and_scale_match_jax(mode):
    """``ImageTransformer`` and ``DataTransforms.scale`` (Pillow's bicubic,
    antialiased down) equal the JAX package's, which calls Pillow, on
    uint8 images up and down, and on a float ``L`` image."""
    img = _uint8_images()[mode]
    X = np.stack([img, img[::-1]])
    for size in ((8, 8), (64, 48), (20, 31), (img.shape[1], 9)):
        ours = ImageTransformer(size).transform_array(X, None, None, None)
        ref = jax_trans.ImageTransformer(size).transform_array(
            X, None, None, None)
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[0].dtype == ref[0].dtype
        np.testing.assert_array_equal(
            DataTransforms(img).scale(size[1], size[0]),
            jax_trans.DataTransforms(img).scale(size[1], size[0]))
    grey = img.astype(np.float32) / 7 if mode == 'L' else None
    if grey is not None:
        np.testing.assert_array_equal(
            pil_resize(grey, (11, 50)),
            jax_trans.DataTransforms(grey).scale(50, 11))
    with pytest.raises(NotImplementedError):
        pil_resize(np.zeros((4, 4, 4), np.uint8), (2, 2))


@pytest.mark.parametrize('method,args', [
    ('center_crop', (8, 6)), ('flip', ('lr',)), ('flip', ('ud',)),
    ('rotate', (90,)), ('rotate', (270,)), ('crop', (2, 3, 7, 5)),
    ('convert2gray', ()), ('shift', (3, -2)), ('gaussian_blur', (1.5,)),
    ('salt_pepper_noise', (0.2,)), ('gaussian_noise', ()),
    ('median_filter', (3,))])
def test_data_transforms_match_jax(method, args):
    img = _uint8_images()['RGB']
    ours = getattr(DataTransforms(img), method)(*args)
    ref = getattr(jax_trans.DataTransforms(img), method)(*args)
    assert np.asarray(ours).dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(ours, ref)


def test_image_dataset_matches_jax():
    """Arrays as given (1-D labels stay 1-D), ones for weights, batches;
    file paths raise (no image decoder in the port)."""
    X = _images(5, 4, 3)
    y = np.arange(5, dtype=np.float32)
    ours, ref = ImageDataset(X, y), JaxImageDataset(X, y)
    for a, b in ((ours.X, ref.X), (ours.y, ref.y), (ours.w, ref.w),
                 (ours.ids, ref.ids)):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).shape == np.asarray(b).shape
    assert ours.get_shape() == ref.get_shape()
    for a, b in zip(ours.iterbatches(2, deterministic=True,
                                     pad_batches=True),
                    ref.iterbatches(2, deterministic=True,
                                    pad_batches=True)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(ours.select([3, 1]).X, X[[3, 1]])
    assert ImageDataset(X, None).y.shape == (5, 1)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ImageDataset(['a.png', 'b.png'], y)
