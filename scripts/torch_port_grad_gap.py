"""float32 against float64 train-step gradients on the CPU, in both packages.

The input is the one chip_smoke.py's train-mode gradient check uses (phase
11): the port's flagship model from create_model(seed 0) with
perturb_zero_init(seed 1) and the DCN offset/mask convs at zero, dropout
off, BatchNorm in train mode, batch 1 from the port's pipeline (raw batch
seed 6, augmentation seed 7). The same weights go into the JAX model (the
port's tensors mapped back to the flax tree), and each package's float32
gradients are held against its own float64 ones (and the two float64 sets
against each other): per tensor max|g32 - g64| / max|g64| (tensors whose
largest float64 gradient exceeds 1e-6) and the L2 error over all of them.

    JAX_PLATFORMS=cpu python scripts/torch_port_grad_gap.py 480

Writes the numbers as JSON to stdout and to torch_port_grad_gap_<res>.json
in the working directory. At 480x480 it needs a few GB of memory and a few
minutes (JAX's float64 compile is most of it).
"""
import copy
import json
import math
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
res = int(sys.argv[1]) if len(sys.argv) > 1 else 480
from chip_smoke import perturb_zero_init, plain_autograd  # noqa: E402
from sgtapose_tpu.config import ModelConfig as JMC  # noqa: E402
from sgtapose_tpu.models.sgta import SGTAPose as JSG  # noqa: E402
from sgtapose_tpu.train import loss as jloss  # noqa: E402
from sgtapose_tpu.train.phases import model_inputs as jmodel_inputs  # noqa: E402
from sgtapose_tpu_torch.config import Config, ModelConfig  # noqa: E402
from sgtapose_tpu_torch.data import pipeline, synthetic  # noqa: E402
from sgtapose_tpu_torch.models.attention import set_dropout_rate  # noqa: E402
from sgtapose_tpu_torch.models.sgta import create_model  # noqa: E402
from sgtapose_tpu_torch.train.loss import sgta_loss  # noqa: E402
from sgtapose_tpu_torch.train.phases import model_inputs  # noqa: E402
from sgtapose_tpu_torch.utils import weights as tw  # noqa: E402
from torch_port_common import no_dropout  # noqa: E402

cfg = Config(model=ModelConfig(input_res=(res, res)))
m = create_model(cfg.model, device="cpu", seed=0)
perturb_zero_init(m, torch.Generator().manual_seed(1))
with torch.no_grad():
    for n, p in m.named_parameters():
        if "conv_offset_mask" in n:
            p.zero_()
set_dropout_rate(m, 0.0)
raw = synthetic.make_raw_batch(torch.Generator().manual_seed(6), 1, device="cpu")
batch = pipeline.make_batch_fn(cfg, synthetic.camera_K())(torch.Generator().manual_seed(7), raw)
batch_np = {k: v.numpy() for k, v in batch.items()}

# the port's tensors -> the flax variable tree (the inverse of load_flax_variables)
jm = JSG(JMC(input_res=(res, res)))
ins = [jnp.asarray(a) for a in jmodel_inputs("PlanA_win", {k: jnp.asarray(v) for k, v in batch_np.items()})]
shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *ins, train=False))
state = {k: v.detach().numpy() for k, v in m.state_dict().items()}
def inv(coll):
    def one(path, s):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        key, tf = tw._target(m, coll, keys)
        t = state[key]
        leaf = keys[-1]
        mod = m.get_submodule(".".join(keys[:-1]))
        if coll == "params" and leaf == "kernel":
            if isinstance(mod, torch.nn.ConvTranspose2d):
                t = t.transpose(2, 3, 1, 0)[::-1, ::-1]
            elif isinstance(mod, torch.nn.Conv2d):
                t = t.transpose(2, 3, 1, 0)
            else:
                t = t.T.reshape(s.shape)
        assert t.shape == s.shape, (keys, t.shape, s.shape)
        return np.ascontiguousarray(t).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, shapes[coll])
variables = {"params": inv("params"), "batch_stats": inv("batch_stats")}
# the round trip gives the port's tensors back exactly
m2 = copy.deepcopy(m); tw.load_flax_variables(m2, variables)
for k, v in m2.state_dict().items():
    assert torch.equal(v, m.state_dict()[k]), k

def jax_grads(dtype):
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    b = {k: (a.astype(dtype) if a.dtype == np.float32 else a) for k, a in batch_np.items()}
    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          *jmodel_inputs("PlanA_win", b), mutable=["batch_stats"], train=True)
        return jloss.sgta_loss(out, b)[0]
    with fnn.intercept_methods(no_dropout):
        l, g = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return float(l), jax.tree_util.tree_map(np.asarray, g)

out = {}
t0 = time.time()
l32, g32 = jax_grads(np.float32); out["jax_f32_s"] = time.time() - t0
with jax.enable_x64(True):
    t0 = time.time(); l64, g64 = jax_grads(np.float64); out["jax_f64_s"] = time.time() - t0
named = dict(m.named_parameters())
J = {"f32": tw._convert(m, {"params": g32}, named), "f64": tw._convert(m, {"params": g64}, named)}

def port_grads(model, b, plain):
    model.train()
    ctx = plain_autograd() if plain else torch.enable_grad()
    with ctx:
        loss, _ = sgta_loss(model(*model_inputs("PlanA_win", b)), b)
        loss.backward()
    return loss.item(), {n: p.grad.double().numpy() for n, p in model.named_parameters() if p.grad is not None}
mp32 = copy.deepcopy(m); mp64 = copy.deepcopy(m).double()
t0 = time.time(); pl32, P32 = port_grads(mp32, batch, False); out["port_f32_s"] = time.time() - t0
b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
t0 = time.time(); pl64, P64 = port_grads(mp64, b64, True); out["port_f64_s"] = time.time() - t0

def cmp(G, R):
    live = [n for n in R if np.abs(R[n]).max() > 1e-6]
    errs = {n: float(np.abs(np.asarray(G[n], np.float64) - R[n]).max() / np.abs(R[n]).max()) for n in live}
    l2 = math.sqrt(sum(((np.asarray(G[n], np.float64) - R[n]) ** 2).sum() for n in live) / sum((R[n] ** 2).sum() for n in live))
    return {"worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3], "l2": l2, "tensors": len(live)}
out.update(res=res, losses=dict(jax_f32=l32, jax_f64=l64, port_f32=pl32, port_f64=pl64),
           jax_f32_vs_jax_f64=cmp(J["f32"], J["f64"]), port_f32_vs_port_f64=cmp(P32, P64),
           port_f64_vs_jax_f64=cmp(P64, J["f64"]), port_f32_vs_jax_f64=cmp(P32, J["f64"]),
           jax_f32_vs_port_f64=cmp(J["f32"], P64), torch=torch.__version__, jax=jax.__version__)
print(json.dumps(out, indent=1))
with open(f"torch_port_grad_gap_{res}.json", "w") as f:
    json.dump(out, f, indent=1)
