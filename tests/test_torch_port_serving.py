"""The port's serving layer against the JAX package's, on the CPU.

* ``MicroBatcher``: the port's and the JAX one, fed the same arrival
  sequence through the same recording fake service, form the same groups
  (the service's calls, in order, with the requests each held) and give
  each request the same slice.  The sequence is queued while the service
  holds a first, full batch, so the grouping does not depend on timing.
  The JAX package's own batcher tests (coalescing and slicing, errors,
  24 concurrent clients) run against both packages with the same
  observations.  A CUDA launch error (``ops._build.check``) in a batch
  resolves every future of its group and counts in ``errors``.
* HTTP: the port's server over a fake service answers the same status
  codes and ``/healthz`` keys as the JAX server over the same service
  (200, 400 for a malformed payload, missing arrays or a size out of
  range, 404 for an unknown path or an unmounted /condition, 500 for a
  kernel's launch error in the batch, counted in ``errors``), and the
  two packages' clients talk to either server.
* The port's server over the tiny CPU services of ``cli.serve`` (the
  reference-layout tree of ``test_torch_port_cli.write_tiny_tree``)
  answers /condition and /tryon bitwise as the services called
  directly.
* ``python -m ladi_vton_tpu_torch.cli.serve --device cpu`` as a process:
  its address on one line, its answer bitwise equal to the in-process
  services for the same seed and request count, a clean exit on SIGINT;
  ``--tensor_parallel 2`` in one process (whose mesh of one rank has no
  model axis of 2) and ``--device cuda`` without a card refused before
  any work.  Serving over ranks: ``test_torch_port_parallel_serving.py``.

Every wait has its own timeout.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_port_cli as port_cli
from ladi_vton_tpu.client import ServingError as JaxServingError
from ladi_vton_tpu.client import TryOnClient as JaxClient
from ladi_vton_tpu.pipelines import serving as jax_serving
from ladi_vton_tpu_torch.cli import serve as serve_cli
from ladi_vton_tpu_torch.client import ServingError, TryOnClient
from ladi_vton_tpu_torch.ops import _build
from ladi_vton_tpu_torch.pipelines import serving

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jax_serving, "port": serving}
TIMEOUT_S = 60
PROCESS_TIMEOUT_S = 240


def req(n: int, val: float, hw=(4, 4), ctx=(7, 8)) -> dict:
    h, w = hw
    return {
        "image": np.full((n, h, w, 3), val, np.float32),
        "inpaint_mask": np.ones((n, h, w, 1), np.float32),
        "pose_map": np.zeros((n, h, w, 18), np.float32),
        "warped_cloth": np.zeros((n, h, w, 3), np.float32),
        "prompt_embeds": np.zeros((n,) + ctx, np.float32),
        "negative_prompt_embeds": np.zeros((n,) + ctx, np.float32),
    }


class RecordingService:
    """Doubles its images; records each call's image values; the first
    call waits for ``release`` (so a sequence can queue behind it).  A
    negative image fails its batch as a refused kernel launch does."""

    height = width = 4

    def __init__(self, batch_size: int, hold_first: bool = False):
        self.batch_size = batch_size
        self.calls = []
        self.release = threading.Event()
        if not hold_first:
            self.release.set()
        self._lock = threading.Lock()

    def generate(self, **arrays):
        assert self.release.wait(TIMEOUT_S)
        with self._lock:
            self.calls.append(arrays["image"][:, 0, 0, 0].tolist())
        if (arrays["image"] < 0).any():
            _build.check(700, "flash_attention")
        return arrays["image"] * 2.0


def wait_taken(mb) -> None:
    """Until the dispatcher has taken the queued full batch (it then goes
    straight to the service, which holds it)."""
    deadline = time.monotonic() + TIMEOUT_S
    while mb._queue.qsize() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not mb._queue.qsize()


def grouping(package, sizes, batch_size: int) -> tuple:
    """(the service's calls after the blocker, each request's output
    values) for requests of ``sizes`` (request i holds the value i + 1)
    queued behind a full blocker batch."""
    svc = RecordingService(batch_size, hold_first=True)
    mb = package.MicroBatcher(svc, max_delay_ms=200.0)
    try:
        blocker = mb.submit(req(batch_size, 0.0))
        wait_taken(mb)
        futs = [mb.submit(req(n, float(i + 1)))
                for i, n in enumerate(sizes)]
        svc.release.set()
        blocker.result(timeout=TIMEOUT_S)
        outs = [f.result(timeout=TIMEOUT_S)[:, 0, 0, 0].tolist()
                for f in futs]
        counters = (mb.requests_done, mb.samples_done, mb.batches_done,
                    mb.errors)
    finally:
        mb.close()
    return svc.calls[1:], outs, counters


@pytest.mark.parametrize("sizes,batch_size", [
    ([1, 2, 1], 8),                   # one group
    ([6, 4, 1, 2, 3], 8),             # overflow puts a request back
    ([1, 3, 2, 2, 1, 4, 1], 4),       # several groups, reordering
])
def test_batcher_groups_equal_jax(sizes, batch_size):
    ours = grouping(serving, sizes, batch_size)
    ref = grouping(jax_serving, sizes, batch_size)
    assert ours == ref
    calls, outs, _ = ours
    assert sorted(v for call in calls for v in call) == sorted(
        float(i + 1) for i, n in enumerate(sizes) for _ in range(n))
    for i, (n, out) in enumerate(zip(sizes, outs)):
        assert out == [2.0 * (i + 1)] * n


def coalesces_and_slices(package) -> list:
    """JAX ``tests/test_pipeline.py test_micro_batcher_coalesces_and_
    slices``, returning what it observes."""
    svc = RecordingService(8)
    mb = package.MicroBatcher(svc, max_delay_ms=500.0)
    seen = []
    try:
        futs = [mb.submit(req(1, 1.0)), mb.submit(req(2, 2.0)),
                mb.submit(req(1, 3.0))]
        outs = [f.result(timeout=TIMEOUT_S) for f in futs]
        seen.append([o[:, 0, 0, 0].tolist() for o in outs])
        seen.append(sorted(len(c) for c in svc.calls))
        svc.calls.clear()
        f1, f2 = mb.submit(req(6, 4.0)), mb.submit(req(4, 5.0))
        seen.append([f1.result(timeout=TIMEOUT_S).shape[0],
                     f2.result(timeout=TIMEOUT_S).shape[0]])
        seen.append([len(c) for c in svc.calls])
        with pytest.raises(ValueError, match="outside"):
            mb.submit(req(9, 0.0))
        with pytest.raises(ValueError, match="missing"):
            mb.submit({"image": np.zeros((1, 4, 4, 3), np.float32)})
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(req(1, 0.0))
    return seen


def test_batcher_coalesces_and_slices_as_jax():
    ours, ref = coalesces_and_slices(serving), coalesces_and_slices(
        jax_serving)
    assert ours == ref
    assert ours[0] == [[2.0], [4.0, 4.0], [6.0]]
    assert ours[3] == [6, 4]


class LaunchErrorService(RecordingService):
    """Raises what a failed kernel launch raises, for one group."""

    def __init__(self, batch_size: int):
        super().__init__(batch_size, hold_first=True)

    def generate(self, **arrays):
        assert self.release.wait(TIMEOUT_S)
        self.calls.append(arrays["image"][:, 0, 0, 0].tolist())
        if len(self.calls) == 2:
            _build.check(700, "flash_attention")
        return arrays["image"]


@pytest.mark.parametrize("package", list(PACKAGES))
def test_an_error_resolves_its_group_and_the_batcher_survives(package):
    mb_cls = PACKAGES[package].MicroBatcher
    svc = LaunchErrorService(4)
    mb = mb_cls(svc, max_delay_ms=200.0)
    try:
        blocker = mb.submit(req(4, 0.0))
        wait_taken(mb)
        failing = [mb.submit(req(1, 1.0)), mb.submit(req(2, 2.0))]
        svc.release.set()
        blocker.result(timeout=TIMEOUT_S)
        for fut in failing:  # one group, one error, every future resolved
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                fut.result(timeout=TIMEOUT_S)
        assert mb.submit(req(2, 3.0)).result(
            timeout=TIMEOUT_S).shape[0] == 2
        assert (mb.errors, mb.batches_done, mb.requests_done,
                mb.samples_done) == (1, 2, 2, 6)
        assert svc.calls == [[0.0] * 4, [1.0, 2.0, 2.0], [3.0, 3.0]]
    finally:
        mb.close()


@pytest.mark.parametrize("package", list(PACKAGES))
def test_batcher_under_24_concurrent_clients(package):
    """JAX ``test_micro_batcher_concurrency_stress`` on both packages."""
    svc = RecordingService(8)
    mb = PACKAGES[package].MicroBatcher(svc, max_delay_ms=50.0)
    results, errors = {}, []

    def client(i):
        try:
            out = mb.submit(req(1, float(i))).result(timeout=TIMEOUT_S)
            results[i] = float(out[0, 0, 0, 0])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: races show
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(results) == 24
        assert all(v == 2.0 * i for i, v in results.items())
        assert len(svc.calls) < 24  # coalesced
        assert mb.samples_done == 24 and mb.requests_done == 24
    finally:
        sys.setswitchinterval(interval)
        mb.close()


# --------------------------------------------------------------------- HTTP


class Server:
    """A package's HTTP server on a free port, in a thread."""

    def __init__(self, package, service, condition_service=None):
        self.batcher = package.MicroBatcher(service, max_delay_ms=5.0)
        self.server = package.make_http_server(
            self.batcher, port=0, condition_service=condition_service)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()
        self.thread.join(TIMEOUT_S)


def _post(url: str, body: bytes) -> tuple:
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, method="POST"), timeout=TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def exchanges(url: str) -> list:
    """(status, JSON keys or the images) for each case, in order."""
    good = req(2, 0.25)
    cases = [
        ("GET", "/healthz", None),
        ("POST", "/tryon", _npz(**good)),
        ("POST", "/tryon", b"not an npz"),
        ("POST", "/tryon", _npz(image=good["image"])),
        ("POST", "/tryon", _npz(**req(5, 0.1))),
        ("POST", "/tryon", _npz(**req(1, -1.0))),
        ("POST", "/nowhere", _npz(**good)),
        ("GET", "/nowhere", None),
        ("POST", "/condition", _npz(**good)),
        ("GET", "/healthz", None),
    ]
    seen = []
    for method, path, body in cases:
        if method == "GET":
            code, obj = _get(url + path)
            seen.append((code, obj if path == "/healthz" else sorted(obj)))
            continue
        code, out = _post(url + path, body)
        if code == 200:
            out = np.load(io.BytesIO(out))["images"].tolist()
        else:
            out = sorted(out)  # the JSON body's keys: {"error"}
        seen.append((code, out))
    return seen


def test_http_server_answers_as_the_jax_server():
    answers = {}
    for name, package in PACKAGES.items():
        server = Server(package, RecordingService(4))
        try:
            answers[name] = exchanges(server.url)
        finally:
            server.close()
    ours, ref = answers["port"], answers["jax"]
    # queue depth aside, which depends on the moment
    for seen in (ours, ref):
        for code, obj in seen:
            if isinstance(obj, dict):
                obj.pop("queue_depth")
    assert ours == ref
    codes = [code for code, _ in ours]
    assert codes == [200, 200, 400, 400, 400, 500, 404, 404, 404, 200]
    health = ours[-1][1]
    assert health == {"status": "ok", "batch_size": 4, "height": 4,
                      "width": 4, "condition": False, "requests_done": 1,
                      "samples_done": 2, "batches_done": 1, "errors": 1}


@pytest.mark.parametrize("server_package", list(PACKAGES))
def test_both_clients_talk_to_both_servers(server_package):
    server = Server(PACKAGES[server_package], RecordingService(4))
    try:
        good = req(2, 0.5)
        for client_cls, error_cls in ((TryOnClient, ServingError),
                                      (JaxClient, JaxServingError)):
            client = client_cls(server.url, timeout_s=TIMEOUT_S)
            np.testing.assert_array_equal(client.tryon(**good),
                                          good["image"] * 2.0)
            assert client.healthz()["status"] == "ok"
            with pytest.raises(error_cls) as err:
                client.tryon(**req(1, -1.0))
            assert err.value.code == 500
            assert "CUDA error 700" in err.value.detail
            with pytest.raises(error_cls) as err:
                client.condition(cloth=good["image"],
                                 pose_map=good["pose_map"],
                                 im_mask=good["image"],
                                 categories=["upper_body"] * 2)
            assert err.value.code == 404
    finally:
        server.close()


# ---------------------------------------------- the tiny services of serve

STEPS = 2
BATCH = 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return port_cli.write_tiny_tree(tmp_path_factory.mktemp("serve_tree"),
                                    datasets=("vitonhd",))


def serve_argv(tree) -> list:
    return ["--dataset", "vitonhd", "--checkpoint_dir", str(tree / "ladi"),
            "--sd2_model_dir", str(tree / "sd2"), "--enable_condition",
            "--clip_vision_dir", str(tree / "clip_vision"),
            "--height", str(port_cli.H), "--width", str(port_cli.W),
            "--num_inference_steps", str(STEPS), "--batch_size", str(BATCH),
            "--mixed_precision", "no", "--seed", "11", "--no_warmup",
            "--max_delay_ms", "5", "--port", "0", "--device", "cpu"]


def raw_request(n: int) -> dict:
    rng = np.random.default_rng(n)
    h, w = port_cli.H, port_cli.W
    return {
        "cloth": rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
        "pose_map": rng.uniform(0, 1, (n, h, w, 18)).astype(np.float32),
        "im_mask": rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
        "image": rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
        "inpaint_mask": (rng.uniform(0, 1, (n, h, w, 1)) > 0.5).astype(
            np.float32),
        "categories": ["upper_body", "dresses"][:n],
    }


def direct_answer(tree, raw: dict) -> tuple:
    """The services of ``cli.serve`` called in this process: the first
    request of a fresh TryOnService (request count 0)."""
    args = serve_cli.parse_args(serve_argv(tree))
    service, cond = serve_cli.build_services(args, torch.device("cpu"))
    warped, ehs, neg = cond.run(cloth=raw["cloth"],
                                pose_map=raw["pose_map"],
                                im_mask=raw["im_mask"],
                                categories=raw["categories"])
    images = service.generate(
        image=raw["image"], inpaint_mask=raw["inpaint_mask"],
        pose_map=raw["pose_map"], warped_cloth=warped, prompt_embeds=ehs,
        negative_prompt_embeds=neg)
    return (warped, ehs, neg), images


def client_answer(client, raw: dict) -> tuple:
    cond = client.condition(cloth=raw["cloth"], pose_map=raw["pose_map"],
                            im_mask=raw["im_mask"],
                            categories=raw["categories"])
    images = client.tryon(
        image=raw["image"], inpaint_mask=raw["inpaint_mask"],
        pose_map=raw["pose_map"], warped_cloth=cond["warped_cloth"],
        prompt_embeds=cond["prompt_embeds"],
        negative_prompt_embeds=cond["negative_prompt_embeds"])
    return (cond["warped_cloth"], cond["prompt_embeds"],
            cond["negative_prompt_embeds"]), images


def assert_same(ours: tuple, ref: tuple) -> None:
    (c1, i1), (c2, i2) = ours, ref
    for a, b in zip(c1 + (i1,), c2 + (i2,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_server_over_the_tiny_services_answers_as_the_services(tree):
    raw = raw_request(2)
    ref = direct_answer(tree, raw)
    args = serve_cli.parse_args(serve_argv(tree))
    service, cond = serve_cli.build_services(args, torch.device("cpu"))
    server = Server(serving, service, condition_service=cond)
    try:
        client = TryOnClient(server.url, timeout_s=TIMEOUT_S)
        assert_same(client_answer(client, raw), ref)
        health = client.healthz()
        assert health["condition"] is True
        assert (health["requests_done"], health["samples_done"],
                health["batches_done"], health["errors"]) == (1, 2, 1, 0)
        # a JAX client reads the same images (the service's second
        # request: its own seed)
        jax_client = JaxClient(server.url, timeout_s=TIMEOUT_S)
        warped, ehs, neg = ref[0]
        out = jax_client.tryon(
            image=raw["image"], inpaint_mask=raw["inpaint_mask"],
            pose_map=raw["pose_map"], warped_cloth=warped,
            prompt_embeds=ehs, negative_prompt_embeds=neg)
        assert out.shape == ref[1].shape and np.isfinite(out).all()
    finally:
        server.close()


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_serve_process_answers_and_stops_on_sigint(tree):
    raw = raw_request(2)
    ref = direct_answer(tree, raw)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ladi_vton_tpu_torch.cli.serve",
         *serve_argv(tree)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        reader = threading.Thread(
            target=lambda: lines.extend(iter(proc.stdout.readline, "")),
            daemon=True)
        reader.start()
        deadline = time.monotonic() + PROCESS_TIMEOUT_S
        url = None
        while url is None and time.monotonic() < deadline:
            for line in list(lines):
                if line.startswith("serving try-on on "):
                    url = line.split()[3]
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        assert url, (proc.poll(), lines, proc.stderr.read()
                     if proc.poll() is not None else "")
        client = TryOnClient(url, timeout_s=TIMEOUT_S)
        assert client.healthz()["status"] == "ok"
        assert_same(client_answer(client, raw), ref)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)


@pytest.mark.parametrize("flags,error,match", [
    (["--tensor_parallel", "2"], ValueError, "does not cover"),
    (["--device", "cuda"], RuntimeError, "CUDA is not available")])
def test_serve_refuses_before_any_work(flags, error, match, tmp_path,
                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--dataset", "vitonhd", "--sd2_model_dir",
            str(tmp_path / "missing"), "--device", "cpu", *flags]
    with pytest.raises(error, match=match):
        serve_cli.main(argv)
