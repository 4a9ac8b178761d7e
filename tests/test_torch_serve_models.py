"""Model functions the serve-plane tests ship to replica processes.

A replica receives its model with ``pickle``, that is by reference, and
imports this module by name (the group gives the child this process's
``sys.path``). So the functions live at module level here, in a module
that imports nothing of JAX: a replica loads only the port. The tests
below check that each ships by reference and computes what the tests
rely on.
"""
import functools
import pickle
import time

import torch

from raydp_tpu_torch.models.transformer import (
    CausalLM,
    SequenceClassifier,
    tiny_transformer,
)
from raydp_tpu_torch.serve.decode import TransformerDecodeEngine
from raydp_tpu_torch.serve.replica_main import default_model, on_device


def sum_model(payloads, bucket, *, delay_s=0.0):
    """Each request's sum, after an optional stall (a slow model)."""
    if delay_s:
        time.sleep(delay_s)
    return [float(sum(p)) for p in payloads]


def sum_on_device(payloads, bucket, *, device="cuda"):
    """Each request's sum, taken on ``device``, with the device its
    tensor lay on: what a replica binds in place of the default."""
    out = []
    for p in payloads:
        t = torch.tensor(p, dtype=torch.float64, device=device)
        out.append({"sum": float(t.sum()), "device": t.device.type})
    return out


def load_decode_engine(path, *, device, num_slots=4, page_tokens=16,
                       **cfg):
    """A decode engine on ``device`` over a ``CausalLM`` whose state dict
    was saved at ``path``; the replica gives ``device``."""
    model = CausalLM(tiny_transformer(**cfg), device=device)
    model.load_state_dict(torch.load(path, map_location=device))
    return TransformerDecodeEngine(model, num_slots=num_slots,
                                   page_tokens=page_tokens)


_CLASSIFIERS = {}


def flash_classifier(device, n_layers=2, seed=0):
    """A bf16 flash ``SequenceClassifier`` with weights from ``seed``,
    built once per process and argument set."""
    key = (str(device), n_layers, seed)
    if key not in _CLASSIFIERS:
        cfg = tiny_transformer(attention_impl="flash", dtype=torch.bfloat16,
                               n_layers=n_layers, d_model=128, n_heads=2,
                               d_ff=256, max_len=128, vocab_size=512)
        _CLASSIFIERS[key] = SequenceClassifier(
            cfg, device=device,
            generator=torch.Generator().manual_seed(seed)).eval()
    return _CLASSIFIERS[key]


def padded_ids(payloads, bucket):
    """Each request's ids padded with 0 to ``bucket``, as one int64
    tensor (the load generator's payloads are floats, ``[1.0] * n``)."""
    return torch.tensor([list(p)[:bucket] + [0] * (bucket - len(p))
                         for p in payloads], dtype=torch.int64)


def classify_batch(payloads, bucket, *, device="cuda", n_layers=2, seed=0):
    """The flash classifier's logits for each request, as floats."""
    model = flash_classifier(device, n_layers, seed)
    with torch.inference_mode():
        logits = model(padded_ids(payloads, bucket).to(device))
    return logits.float().cpu().tolist()


def test_model_functions_ship_by_reference():
    for fn in (sum_model, functools.partial(sum_model, delay_s=0.1),
               functools.partial(sum_on_device, device="cuda"),
               functools.partial(load_decode_engine, "/nonexistent"),
               functools.partial(classify_batch, device="cpu")):
        blob = pickle.dumps(fn)
        back = pickle.loads(blob)
        assert getattr(back, "func", back) is getattr(fn, "func", fn)
        assert b"test_torch_serve_models" in blob


def test_sum_model_agrees_with_default_model():
    payloads = [[1, 2, 3], [4], [5, 6, 7, 8]]
    assert sum_model(payloads, 16) == default_model(payloads, 16)
    assert sum_model([[9]], 4, delay_s=0.01) == [9.0]


def test_classify_batch_pads_with_zero_ids():
    payloads = [[3, 1, 4], [1, 5, 9, 2, 6]]
    got = classify_batch(payloads, 8, device="cpu")
    model = flash_classifier("cpu")
    with torch.inference_mode():
        want = model(torch.tensor([[3, 1, 4, 0, 0, 0, 0, 0],
                                   [1, 5, 9, 2, 6, 0, 0, 0]])).float()
    assert torch.equal(torch.tensor(got), want)
    assert all(isinstance(x, float) for row in got for x in row)


def test_replica_binds_its_device_over_the_callers():
    """``on_device`` gives a function with a ``device`` keyword the
    replica's device, over any the caller bound; one without it runs
    as it is."""
    fn = on_device(functools.partial(sum_on_device, device="cuda"),
                   torch.device("cpu"))
    assert fn([[1, 2], [3]], 4) == [{"sum": 3.0, "device": "cpu"},
                                    {"sum": 3.0, "device": "cpu"}]
    assert on_device(sum_model, torch.device("cpu")) is sum_model
    assert on_device(default_model, torch.device("cpu")) is default_model
    factory = on_device(functools.partial(load_decode_engine, "x"), "cpu")
    assert factory.keywords["device"] == "cpu"
