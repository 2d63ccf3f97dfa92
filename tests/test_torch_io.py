"""`fluid.io` of the port (paddle_tpu_torch, on the CPU) against the JAX
package's, in both directions, for every format: the per-var ``.npy``
files with the bfloat16 sidecar, the ``filename=`` pickle, ``fluid.save``'s
``.pdparams`` / ``.pdopt`` / ``.pdmodel``, ``load_program_state`` /
``set_program_state`` and the inference model (``__model__``).

Three models, each built in both packages with the same names: the MNIST
MLP (Adam), BERT-tiny (sequence 16, batch 2, dropout off) under bf16 AMP
O2 with fused Adam, and ResNet18 at 16 x 16 (batch 4, Momentum) with
zero-gamma (every residual branch's last batch-norm scale 0). The port's
startup program gives the start state (the reference's would cost a
compile of its initializers); the reference runs one step from it and
writes every format; the
port loads each into a fresh scope (every value bit-equal to the
reference's), writes every format from that state, reads its own files
back (bit-equal) and the reference reads the port's (bit-equal). Then the
next step: the port's from the reference's files against the reference's
from the port's, losses and gradients within rtol 1e-5 in float32 and
1e-2 under AMP. Each reference program compiles once per module."""
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rfluid
from paddle_tpu.core.scope import Scope as RScope
from paddle_tpu.fluid import io as rio
from paddle_tpu.fluid.contrib import mixed_precision as rmp
from paddle_tpu.models import bert as rbert
from paddle_tpu.models import resnet as rresnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import load_numpy_state
from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("mnist", "bert_amp", "resnet")
FORMATS = ("npy", "pickle", "pdparams", "program_state", "inference")
#: the loss's and the gradients' tolerances of each model against the
#: reference (ResNet's are tests/test_torch_fluid_resnet.py's)
RTOL = {"mnist": 1e-5, "bert_amp": 1e-2, "resnet": 1e-4}
GRAD_RTOL = {"mnist": 1e-5, "bert_amp": 1e-2, "resnet": 1e-3}
SEQ, BERT_BATCH = 16, 2
IMG, RES_BATCH, CLASSES = 16, 4, 10
#: (model, format) cases: BERT's pretraining loss has no feed-to-fetch
#: head to export as an inference model
CASES = [(m, f) for m in MODELS for f in FORMATS
         if not (m == "bert_amp" and f == "inference")]


# -- the models, in either package -----------------------------------------

def _mnist(fluid, mp, bert, resnet):
    x = fluid.layers.data(name="x", shape=[32], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=16, act="relu")
    logits = fluid.layers.fc(input=h, size=10)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits, y))
    fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return loss, ["x"], logits


def _bert_cfg(bert):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _bert_amp(fluid, mp, bert, resnet):
    total, _, _, _ = bert.bert_pretrain_loss(_bert_cfg(bert), SEQ,
                                             scan_layers=True)
    opt = mp.decorate(fluid.optimizer.AdamOptimizer(1e-3),
                      use_dynamic_loss_scaling=False)
    opt.minimize(total)
    fluid.fuse_optimizer_ops(fluid.default_main_program())
    return total, None, None


def _resnet(fluid, mp, bert, resnet):
    img = fluid.layers.data(name="image", shape=[3, IMG, IMG],
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logits = resnet.resnet(img, class_dim=CLASSES, depth=18)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits, label))
    fluid.optimizer.MomentumOptimizer(1e-2, momentum=0.9).minimize(loss)
    return loss, ["image"], logits


BUILDERS = {"mnist": _mnist, "bert_amp": _bert_amp, "resnet": _resnet}


def _build(fluid, model):
    mods = (rmp, rbert, rresnet) if fluid is rfluid else \
        (tmp, tbert, tresnet)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name_guard():
        loss, feeds, head = BUILDERS[model](fluid, *mods)
    grads = sorted(v.name for v in main.list_vars()
                   if v.name.endswith("@GRAD") and v.name[:-5] in {
                       p.name for p in main.all_parameters()})
    return main, startup, loss, feeds, head, grads


def _feed(model):
    r = np.random.RandomState(1)
    if model == "mnist":
        return {"x": r.randn(8, 32).astype("float32"),
                "y": r.randint(0, 10, (8, 1)).astype("int64")}
    if model == "resnet":
        return {"image": r.randn(RES_BATCH, 3, IMG, IMG).astype("float32"),
                "label": r.randint(0, CLASSES, (RES_BATCH, 1))
                .astype("int64")}
    return tbert.bert_feed(_bert_cfg(tbert), BERT_BATCH, SEQ)


def _bits(v):
    """A value's bits as a numpy array (bfloat16 as uint16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rel(a, b):
    a = _bits_float(a)
    b = _bits_float(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bits_float(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(v).astype(np.float64)


# -- the two packages' savers and loaders -----------------------------------

def _ref_save(fmt, exe, main, feeds, head, d):
    if fmt == "npy":
        rio.save_persistables(exe, d, main)
    elif fmt == "pickle":
        rio.save_persistables(exe, d, main, filename="all.pkl")
    elif fmt in ("pdparams", "program_state"):
        rio.save(main, os.path.join(d, "model"))
    elif feeds is not None:
        rio.save_inference_model(d, feeds, [head], exe, main)


def _port_save(fmt, exe, main, feeds, head, d):
    if fmt == "npy":
        tio.save_persistables(exe, d, main)
    elif fmt == "pickle":
        tio.save_persistables(exe, d, main, filename="all.pkl")
    elif fmt in ("pdparams", "program_state"):
        tio.save(main, os.path.join(d, "model"))
    else:
        tio.save_inference_model(d, feeds, [head], exe, main)


def _load(io, fmt, exe, main, d):
    """Load `fmt` from `d` into the current global scope of `io`'s
    package; returns the inference program for "inference"."""
    if fmt == "npy":
        io.load_persistables(exe, d, main)
    elif fmt == "pickle":
        io.load_persistables(exe, d, main, filename="all.pkl")
    elif fmt == "pdparams":
        io.load(main, os.path.join(d, "model"), exe)
    elif fmt == "program_state":
        io.set_program_state(main, io.load_program_state(
            os.path.join(d, "model")))
    else:
        return io.load_inference_model(d, exe)[0]
    return None


def _infer_names(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Per model, everything the tests compare (see the module
    docstring)."""
    out = {}
    for model in MODELS:
        base = tmp_path_factory.mktemp(model)
        feed = _feed(model)
        rmain, _, rloss, feeds, rhead, grads = _build(rfluid, model)
        tmain, tstart, tloss, _, thead, tgrads = _build(tfluid, model)
        assert tgrads == grads and _infer_names(tmain) == _infer_names(rmain)
        texe = tfluid.Executor(tfluid.CPUPlace())
        rexe = rfluid.Executor(rfluid.CPUPlace())
        rs = RScope()
        names = _infer_names(rmain)
        # the start state: the port's startup program's (the reference's
        # would cost a compile of its initializers)
        t0 = tfluid.Scope()
        texe.run(tstart, scope=t0)
        for n in names:
            rs.set_var(n, jnp.asarray(to_numpy(t0.find_var(n))))
        with rfluid.scope_guard(rs):
            if model == "resnet":
                for n in names:
                    if n.endswith("_branch2b_bn_scale"):
                        rs.set_var(n, np.zeros_like(np.asarray(
                            rs.find_var(n))))
            fetch = [rloss.name] + grads
            rexe.run(rmain, feed=feed, fetch_list=fetch)
            s1 = {n: np.asarray(rs.find_var(n)) for n in names}
            for fmt in FORMATS:
                os.makedirs(base / ("ref_" + fmt))
                _ref_save(fmt, rexe, rmain, feeds, rhead,
                          str(base / ("ref_" + fmt)))

        res = {"s1": s1, "port_loaded": {}, "port_round": {},
               "ref_loaded": {}, "names": names}
        for fmt in FORMATS:
            ts = tfluid.Scope()
            d = str(base / ("ref_" + fmt))
            with tfluid.scope_guard(ts):
                if fmt == "inference" and feeds is None:
                    continue
                if fmt == "program_state":
                    # set_program_state takes no executor: the values go
                    # where the startup put the scope's
                    texe.run(tstart)
                prog = _load(tio, fmt, texe, tmain, d)
            want = _infer_names(prog) if prog is not None else names
            res["port_loaded"][fmt] = {n: ts.find_var(n) for n in want}
        # the port's state: the reference's s1, written in each format,
        # read back by the port and by the reference
        ts = tfluid.Scope()
        load_numpy_state(ts, s1, "cpu")
        fmts = [f for f in FORMATS if f != "inference" or feeds]
        with tfluid.scope_guard(ts):
            for fmt in fmts:
                d = str(base / ("port_" + fmt))
                os.makedirs(d)
                _port_save(fmt, texe, tmain, feeds, thead, d)
        for fmt in fmts:
            d = str(base / ("port_" + fmt))
            back = tfluid.Scope()
            with tfluid.scope_guard(back):
                if fmt == "program_state":
                    texe.run(tstart)
                prog = _load(tio, fmt, texe, tmain, d)
            want = _infer_names(prog) if prog is not None else names
            res["port_round"][fmt] = {n: back.find_var(n) for n in want}
            rsc = RScope()
            with rfluid.scope_guard(rsc):
                prog = _load(rio, fmt, rexe, rmain, d)
            want = _infer_names(prog) if prog is not None else names
            res["ref_loaded"][fmt] = {n: np.asarray(rsc.find_var(n))
                                      for n in want}
        # the next step: the port's from the reference's files, the
        # reference's from the port's (into its own scope: one compile)
        tsn = tfluid.Scope()
        with tfluid.scope_guard(tsn):
            tio.load_persistables(texe, str(base / "ref_npy"), tmain)
            got = texe.run(tmain, feed=feed, fetch_list=[tloss.name] + grads)
        tsc = tfluid.Scope()
        load_numpy_state(tsc, s1, "cpu")
        res["port_step_carried"] = texe.run(
            tmain, feed=feed, fetch_list=[tloss.name] + grads, scope=tsc)
        with rfluid.scope_guard(rs):
            rio.load_persistables(rexe, str(base / "port_npy"), rmain)
            want = rexe.run(rmain, feed=feed, fetch_list=fetch)
        res["port_step"] = got
        res["ref_step"] = [np.asarray(v) for v in want]
        res["grads"] = grads
        if feeds is not None:
            # the inference model: the reference's pruned program from
            # the port's files against the port's from the reference's
            infeed = {k: feed[k] for k in feeds}
            rsc = RScope()
            with rfluid.scope_guard(rsc):
                rprog, rfeeds, rfetch = rio.load_inference_model(
                    str(base / "port_inference"), rexe)
                res["ref_infer"] = np.asarray(rexe.run(
                    rprog, feed=infeed, fetch_list=rfetch)[0])
            tsc = tfluid.Scope()
            with tfluid.scope_guard(tsc):
                tprog, tfeeds, tfetch = tio.load_inference_model(
                    str(base / "ref_inference"), texe)
                res["port_infer"] = texe.run(tprog, feed=infeed,
                                             fetch_list=tfetch)[0]
            assert rfeeds == tfeeds == feeds
        res["base"] = base
        out[model] = res
    return out


@pytest.mark.parametrize("model,fmt", CASES)
def test_reference_files_load_in_port(crossed, model, fmt):
    """Every value the reference wrote loads in the port bit for bit, in
    the reference's dtype (bfloat16 params of AMP O2 as bfloat16)."""
    res = crossed[model]
    loaded = res["port_loaded"][fmt]
    assert loaded
    for n, v in loaded.items():
        want = res["s1"][n]
        assert isinstance(v, torch.Tensor), n
        if want.dtype.name == "bfloat16":
            assert v.dtype == torch.bfloat16, n
        np.testing.assert_array_equal(_bits(v), _bits(want), err_msg=n)


@pytest.mark.parametrize("model,fmt", CASES)
def test_port_files_load_in_reference(crossed, model, fmt):
    """Every value the port wrote loads in the reference bit for bit;
    bfloat16 ones as the reference's own bfloat16 arrays."""
    res = crossed[model]
    for n, v in res["ref_loaded"][fmt].items():
        want = res["s1"][n]
        assert v.dtype == want.dtype, (n, v.dtype, want.dtype)
        np.testing.assert_array_equal(_bits(v), _bits(want), err_msg=n)


@pytest.mark.parametrize("model,fmt", CASES)
def test_port_round_trip_bit_equal(crossed, model, fmt):
    res = crossed[model]
    got = res["port_round"][fmt]
    assert got
    for n, v in got.items():
        np.testing.assert_array_equal(_bits(v), _bits(res["s1"][n]),
                                      err_msg=n)


@pytest.mark.parametrize("model", MODELS)
def test_next_step_after_cross_load(crossed, model):
    """The port's step from the reference's files and the reference's
    from the port's: the loss within the model's tolerance, and the
    gradients: in float32 each within its rtol (relative norm); under
    AMP the whole gradient vector within 1e-2 (its bfloat16 bias
    gradients alone differ by up to 1.5e-2 between the packages, one
    bfloat16 step of their sums' order). The port's step from the files
    is bit-equal to its step from the state carried over in memory
    (`load_numpy_state`)."""
    res = crossed[model]
    rtol = RTOL[model]
    got, want = res["port_step"], res["ref_step"]
    for a, b in zip(got, res["port_step_carried"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(got[0].ravel()[0]),
                               float(want[0].ravel()[0]), rtol=rtol)
    if model == "bert_amp":
        g = np.concatenate([_bits_float(v).ravel() for v in got[1:]])
        w = np.concatenate([_bits_float(v).ravel() for v in want[1:]])
        assert _rel(g, w) <= GRAD_RTOL[model], _rel(g, w)
        return
    worst = max((_rel(g, w), n) for g, w, n in zip(got[1:], want[1:],
                                                   res["grads"]))
    assert worst[0] <= GRAD_RTOL[model], worst


@pytest.mark.parametrize("model", ["mnist", "resnet"])
def test_inference_model_cross_load(crossed, model):
    res = crossed[model]
    np.testing.assert_allclose(res["port_infer"], res["ref_infer"],
                               rtol=RTOL[model], atol=1e-6)


def test_pdmodel_desc_builds_the_program_op_by_op(crossed):
    """The reference's ``.pdmodel`` read by the port's restricted
    unpickler rebuilds the port's own program: blocks, ops, slots and
    vars."""
    base = crossed["bert_amp"]["base"]
    desc = tio._load_pickle(os.path.join(base, "ref_pdparams",
                                         "model.pdmodel"))
    prog = tio._desc_to_program(desc)
    tmain = _build(tfluid, "bert_amp")[0]
    assert len(prog.blocks) == len(tmain.blocks)
    for a, b in zip(prog.blocks, tmain.blocks):
        assert [op.type for op in a.ops] == [op.type for op in b.ops]
        assert [(op.input_names, op.output_names) for op in a.ops] == \
            [(op.input_names, op.output_names) for op in b.ops]
        assert {n: (tuple(v.shape), v.dtype, v.persistable)
                for n, v in a.vars.items()} == \
            {n: (tuple(v.shape), v.dtype, v.persistable)
             for n, v in b.vars.items()}


def test_amp_inference_round_trip_matches_for_test_clone(crossed):
    """The port's inference model of the AMP program keeps its casts
    (the desc's "amp" entry): the loaded pruned program's fetch equals
    the for_test clone's on the same feed, bit for bit."""
    tmain, tstart, tloss, _, _, _ = _build(tfluid, "bert_amp")
    feed = _feed("bert_amp")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    load_numpy_state(scope, crossed["bert_amp"]["s1"], "cpu")
    test = tmain.clone(for_test=True)
    d = str(crossed["bert_amp"]["base"] / "amp_infer")
    with tfluid.scope_guard(scope):
        want = exe.run(test, feed=feed, fetch_list=[tloss.name])[0]
        tio.save_inference_model(d, sorted(feed), [tloss.name], exe, tmain)
    other = tfluid.Scope()
    with tfluid.scope_guard(other):
        prog, feeds, fetch = tio.load_inference_model(d, exe)
        got = exe.run(prog, feed=feed, fetch_list=fetch)[0]
    assert getattr(prog, "_amp", False)
    np.testing.assert_array_equal(got, want)


def test_float32_file_loads_into_bf16_param_as_bf16(tmp_path):
    """A float32 value for a var the scope holds as bfloat16 (AMP O2's
    live params) lands as bfloat16: the next replay must not see a dtype
    change."""
    main = _build(tfluid, "bert_amp")[0]
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    bf16 = [p.name for p in main.all_parameters() if p.dtype == "bfloat16"]
    assert bf16
    name = bf16[0]
    shape = tuple(main.global_block().var(name).shape)
    scope.set_var(name, torch.zeros(shape, dtype=torch.bfloat16))
    np.save(str(tmp_path / (name + ".npy")),
            np.full(shape, 1.5, np.float32))
    with tfluid.scope_guard(scope):
        tio.load_vars(exe, str(tmp_path), main, vars=[name])
    v = scope.find_var(name)
    assert v.dtype == torch.bfloat16 and float(v.float().mean()) == 1.5


def test_restricted_unpickler_refuses_other_classes(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"w": Evil()}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tio._load_pickle(path)


def test_bf16_files_without_ml_dtypes(crossed):
    """A process where ``ml_dtypes`` cannot be imported (the card's
    machine) reads the reference's bfloat16 files, npy and pickle, as
    ``torch.bfloat16`` (never a float32 view of the bits), and writes
    them back byte-compatible; the reference then reads the rewritten
    pickle as its own bfloat16."""
    base = crossed["bert_amp"]["base"]
    out = base / "noml"
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from paddle_tpu_torch.fluid import io\n"
        "d = io._load_dict(%r)\n"
        "p = io._load_pickle(%r)\n"
        "bf = [n for n, v in d.items() if isinstance(v, torch.Tensor)\n"
        "      and v.dtype == torch.bfloat16]\n"
        "assert bf and all(torch.equal(d[n].view(torch.int16),\n"
        "                  p[n].view(torch.int16)) for n in bf), bf\n"
        "io._save_dict(%r, p, 'again.pkl')\n"
        "io._save_dict(%r, p)\n"
        "assert 'jax' not in sys.modules\n"
        "print('BF16', len(bf))\n") % (
            str(base / "ref_npy"), str(base / "ref_pickle" / "all.pkl"),
            str(out), str(out))
    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "BF16" in r.stdout, r.stderr
    s1 = crossed["bert_amp"]["s1"]
    with open(out / "again.pkl", "rb") as f:
        again = pickle.load(f)
    npy = rio._load_dict(str(out))
    for n, want in s1.items():
        assert again[n].dtype == want.dtype, n
        np.testing.assert_array_equal(_bits(again[n]), _bits(want))
        np.testing.assert_array_equal(_bits(npy[n]), _bits(want))
