"""The port's server (flux_generator_tpu_torch/server/) on the CPU: the
JAX package's API tests (tests/test_server_api.py), its UI smoke tests
(tests/test_ui_smoke.py) and the non-slow parts of its integration tests,
against the port's FluxAPI and HTTP server. Mocked pipelines return torch
tensors; the integration tests serve the port's tiny pipelines and hold a
served image to the same pipeline's direct call, byte for byte (the same
arithmetic on the same device, so no tolerance), and its schemas to the JAX
package's pydantic models."""

import base64
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flux_generator_tpu.server import schemas as jschemas
from flux_generator_tpu.server import ui as jui
from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL
from flux_generator_tpu_torch.server import schemas, ui
from flux_generator_tpu_torch.server.api import FluxAPI, MAX_SIDE, _fetch_u8, _png_data_url, to_latent_size
from flux_generator_tpu_torch.server.app import check_port_available, find_available_port, get_app, main
from flux_generator_tpu_torch.server.httpd import Server
from flux_generator_tpu_torch.utils.audio import save_audio
from tests import test_ui_smoke as jsmoke

BUDGET_GB = 80.0  # the planner's memory on the CPU (it reads the card's otherwise)


class _MockFluxPipeline:
    """FluxPipeline's conditioning-first generator protocol."""

    def generate_latents(self, text, n_images=1, num_steps=2, latent_size=(64, 64), guidance=4.0, seed=None):
        yield ("cond",)
        for _ in range(num_steps):
            yield torch.zeros((n_images, latent_size[0] * latent_size[1] // 4, 64))

    def decode(self, x, latent_size):
        return torch.full((1, latent_size[0] * 8, latent_size[1] * 8, 3), 0.5)


class _MockSDPipeline:
    def generate_latents(self, text, n_images=1, cfg_weight=7.5, num_steps=2, negative_text="",
                         latent_size=(64, 64), seed=None):
        for _ in range(num_steps):
            yield torch.zeros((n_images, *latent_size, 4))

    def generate_latents_from_image(self, image, text, n_images=1, strength=0.8, num_steps=2, cfg_weight=7.5,
                                    negative_text="", seed=None):
        assert isinstance(image, torch.Tensor) and image.dtype == torch.float32
        for _ in range(max(1, int(num_steps * strength))):
            yield torch.zeros((n_images, image.shape[0] // 8, image.shape[1] // 8, 4))

    def decode(self, x):
        return torch.full((1, x.shape[1] * 8, x.shape[2] * 8, 3), 0.25)


class _MockMusicPipeline:
    sampling_rate = 32000

    def generate(self, prompt, max_steps=500, top_k=250, temp=1.0, guidance_coef=3.0, seed=None):
        return torch.zeros(max_steps * 640)


def _mock_api(**kwargs):
    api = FluxAPI(pipeline_factory=lambda name: _MockFluxPipeline(), sd_factory=lambda name: _MockSDPipeline(),
                  budget_gb=BUDGET_GB, **kwargs)
    api._music_factory = _MockMusicPipeline
    return api


@pytest.fixture(scope="module")
def api():
    return _mock_api()


@pytest.fixture(scope="module")
def server(api):
    srv = Server(api, "127.0.0.1", 0)
    srv.start_background()
    yield f"http://127.0.0.1:{srv.port}"
    srv.shutdown()


def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, json.dumps(payload).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.status, json.loads(r.read())


def _status(url, payload):
    try:
        return _post(url, payload)[0], None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ------------------------------------------------------------ schemas (against pydantic)


@pytest.mark.parametrize("name", ["SDAPIRequest", "SDAPIResponse", "Img2ImgRequest", "MusicRequest"])
def test_schema_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jschemas, name), getattr(schemas, name)
    want = {k: (f.is_required(), None if f.is_required() else f.default) for k, f in jcls.model_fields.items()}
    import dataclasses

    got = {f.name: (f.default is dataclasses.MISSING, None if f.default is dataclasses.MISSING else f.default)
           for f in dataclasses.fields(tcls)}
    assert got == want


PAYLOADS = [
    {"prompt": "x"}, {"prompt": "x", "width": True}, {"prompt": "x", "width": 5.0}, {"prompt": "x", "width": 5.5},
    {"prompt": "x", "width": "64"}, {"prompt": "x", "width": " 64 "}, {"prompt": 3},
    {"prompt": "x", "cfg_scale": "2.5"}, {"prompt": "x", "cfg_scale": True}, {"prompt": "x", "negative_prompt": None},
    {"prompt": "x", "steps": None}, {"prompt": "x", "bogus": 1}, {"prompt": "x", "width": None},
    {"prompt": "x", "width": "1e3"}, {"prompt": "x", "seed": -1.0}, {}, {"no_prompt": True},
    {"prompt": "x", "init_images": ["a", "b"]}, {"prompt": "x", "init_images": "a"}, {"prompt": "x", "init_images": [1]},
]


@pytest.mark.parametrize("name", ["SDAPIRequest", "Img2ImgRequest", "MusicRequest"])
def test_schema_validation_matches_pydantic(name):
    """Accepted payloads parse to pydantic's values; refused ones raise
    ValueError (HTTP 422) where pydantic raises its ValidationError."""
    jcls, tcls = getattr(jschemas, name), getattr(schemas, name)
    for payload in PAYLOADS:
        try:
            want = jcls(**payload).model_dump()
        except ValueError:
            want = "refused"
        try:
            got = tcls(**payload).model_dump()
        except ValueError:
            got = "refused"
        assert got == want, payload


def test_model_dump_exclude():
    req = schemas.Img2ImgRequest(prompt="p", init_images=["a"])
    assert req.model_dump(exclude={"init_images"}) == jschemas.Img2ImgRequest(
        prompt="p", init_images=["a"]).model_dump(exclude={"init_images"})


# ------------------------------------------------------------ the API (tests/test_server_api.py)


def test_to_latent_size_rounds_to_16():
    assert to_latent_size((512, 512)) == (64, 64)
    assert to_latent_size((500, 500)) == (64, 64)
    assert to_latent_size((513, 520)) == (66, 66)
    with pytest.raises(ValueError, match="exceeds"):
        to_latent_size((MAX_SIDE + 1, 64))


def test_request_defaults():
    req = schemas.SDAPIRequest(prompt="hi")
    assert req.width == 512 and req.height == 512
    assert req.seed == -1 and req.model == "schnell"


def test_txt2img_endpoint(server):
    status, data = _post(server + "/sdapi/v1/txt2img", {"prompt": "a cat", "width": 128, "height": 128, "steps": 2})
    assert status == 200
    assert len(data["images"]) == 1
    assert data["images"][0].startswith("data:image/png;base64,")
    assert data["parameters"]["prompt"] == "a cat"
    assert "info" in data


def test_txt2img_sd_model(server):
    status, data = _post(server + "/sdapi/v1/txt2img",
                         {"prompt": "x", "model": "stabilityai/sdxl-turbo", "width": 64, "height": 64})
    assert status == 200
    assert data["images"][0].startswith("data:image/png;base64,")


def test_img2img_endpoint(server):
    status, data = _post(server + "/sdapi/v1/img2img",
                         {"prompt": "x", "init_images": [_png(np.zeros((64, 64, 3), np.uint8))], "width": 64,
                          "height": 64, "steps": 2, "model": "stabilityai/stable-diffusion-2-1-base"})
    assert status == 200
    assert data["images"][0].startswith("data:image/png;base64,")
    assert "init_images" not in data["parameters"]


def test_sd_models_endpoint(server):
    status, models = _get(server + "/sdapi/v1/sd-models")
    assert status == 200
    assert {m["title"] for m in models} == {"flux-schnell", "flux-dev", "stabilityai/stable-diffusion-2-1-base",
                                             "stabilityai/sdxl-turbo"}
    for m in models:
        for key in ("title", "name", "model_name", "hash", "sha256", "filename", "config"):
            assert key in m


def test_options_endpoints(server):
    status, opts = _get(server + "/sdapi/v1/options")
    assert status == 200
    assert "sd_model_checkpoint" in opts and len(opts["sd_model_list"]) == 4
    assert "JAX" not in opts["sd_backend"] and "PyTorch" in opts["sd_backend"]
    status, res = _post(server + "/sdapi/v1/options", {"sd_model_checkpoint": "flux-dev"})
    assert status == 200 and res["success"] is True


def test_progress_endpoint(server):
    status, prog = _get(server + "/sdapi/v1/progress")
    assert status == 200
    for key in ("progress", "eta_relative", "state", "current_image", "textinfo"):
        assert key in prog
    assert prog["textinfo"] == "Idle"


def test_progress_tracks_steps(api):
    api.progress.start("job", 4)
    api.progress.step(2)
    snap = api.progress.snapshot()
    assert snap["progress"] == 0.5 and "2/4" in snap["textinfo"]
    api.progress.start("", 0)


def test_ui_and_docs_served(server):
    with urllib.request.urlopen(server + "/") as r:
        body = r.read().decode()
    assert "Flux Generator" in body and "Music Generation" in body
    with urllib.request.urlopen(server + "/docs") as r:
        assert "txt2img" in r.read().decode()


def test_health_and_cors(server):
    with urllib.request.urlopen(server + "/health") as r:
        assert json.loads(r.read()) == {"status": "ok"}
        assert r.headers["Access-Control-Allow-Origin"] == "*"
    req = urllib.request.Request(server + "/sdapi/v1/txt2img", method="OPTIONS")
    with urllib.request.urlopen(req) as r:
        assert r.status == 204


def test_error_returns_500():
    def boom(name):
        raise RuntimeError("model load exploded")

    srv = Server(FluxAPI(pipeline_factory=boom, budget_gb=BUDGET_GB), "127.0.0.1", 0)
    srv.start_background()
    try:
        code, body = _status(f"http://127.0.0.1:{srv.port}/sdapi/v1/txt2img", {"prompt": "x"})
        assert code == 500 and "exploded" in body["detail"]
    finally:
        srv.shutdown()


@pytest.mark.parametrize("path,payload", [
    ("/sdapi/v1/txt2img", {"no_prompt": True}), ("/sdapi/v1/txt2img", {"prompt": "x", "width": "wide"}),
    ("/sdapi/v1/img2img", {"prompt": "x"}), ("/api/music", {"max_steps": 8}),
])
def test_422_on_bad_request(server, path, payload):
    assert _status(server + path, payload)[0] == 422


def test_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404
    assert _status(server + "/nope", {})[0] == 404


def test_concurrent_requests_serialized(server):
    results = []

    def go():
        results.append(_post(server + "/sdapi/v1/txt2img", {"prompt": "x", "width": 64, "height": 64, "steps": 1})[0])

    threads = [threading.Thread(target=go) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert results == [200, 200]


def test_port_probing():
    port = find_available_port("127.0.0.1", 49500)
    assert check_port_available("127.0.0.1", port)


@pytest.mark.parametrize("path,payload", [
    ("/sdapi/v1/txt2img", {"prompt": "x", "model": "flux-schnell", "width": 8192, "height": 8192}),
    ("/sdapi/v1/img2img", {"prompt": "x", "init_images": ["x"], "width": 4096, "height": 64}),
])
def test_oversize_request_rejected(server, path, payload):
    code, body = _status(server + path, payload)
    assert code == 422 and "exceeds" in body["detail"]


def test_queue_full_returns_429():
    api = FluxAPI(pipeline_factory=lambda name: None, max_queue=1, budget_gb=BUDGET_GB)
    assert api._queue_slots.acquire(blocking=False)
    srv = Server(api, "127.0.0.1", 0)
    srv.start_background()
    try:
        for path, payload in (("/sdapi/v1/txt2img", {"prompt": "x", "model": "flux-schnell"}),
                              ("/api/music", {"prompt": "x"})):
            code, body = _status(f"http://127.0.0.1:{srv.port}{path}", payload)
            assert code == 429 and "queue full" in body["detail"]
    finally:
        api._queue_slots.release()
        srv.shutdown()


def test_seedless_requests_get_fresh_random_seeds():
    seen = []

    class _Recorder(_MockFluxPipeline):
        def generate_latents(self, text, seed=None, **kw):
            seen.append(seed)
            return super().generate_latents(text, seed=seed, **kw)

    api = FluxAPI(pipeline_factory=lambda name: _Recorder(), budget_gb=BUDGET_GB)
    for _ in range(2):
        api.txt2img(schemas.SDAPIRequest(prompt="x", model="flux-schnell", width=64, height=64, steps=1))
    assert len(seen) == 2 and all(s is not None for s in seen) and seen[0] != seen[1], seen


def test_buckets_for_per_family_ladders():
    api = FluxAPI(budget_gb=BUDGET_GB)
    assert api._buckets_for("flux-schnell")[-1] == api._buckets_for("flux-dev")[-1] == 4
    assert api._buckets_for("stabilityai/stable-diffusion-2-1-base")[-1] == 8
    assert api._buckets_for("stabilityai/sdxl-turbo")[-1] == 8


def test_quantize_and_w8a8_reach_the_loads():
    """`quantize` lifts a bf16 plan to int8; `w8a8` is set on every
    pipeline the API loads (the JAX package's FGT_QUANTIZE and set_w8a8)."""

    class _Pipe:
        w8a8 = None

    api = FluxAPI(pipeline_factory=lambda name: _Pipe(), sd_factory=lambda name: _Pipe(), quantize=True,
                  w8a8="fused", budget_gb=BUDGET_GB)
    api._music_factory = _Pipe
    for pipe in (api.init_pipeline("flux-schnell"), api.init_pipeline("stabilityai/sdxl-turbo"),
                 api.init_music_pipeline()):
        assert pipe.w8a8 == "fused"
    assert {s.policy for s in api.memory.slots.values()} == {"int8"}
    assert FluxAPI(budget_gb=BUDGET_GB)._plan_load("flux", "flux-schnell") == "bf16"


def test_cli_flags(monkeypatch):
    """--quantize and --w8a8 (bare: "ops") reach the FluxAPI that main builds."""
    made = {}

    class _Stop(Exception):
        pass

    class _Srv:
        def __init__(self, api, host, port):
            made.update(api=api, host=host)
            raise _Stop

    monkeypatch.setattr("flux_generator_tpu_torch.server.app.Server", _Srv)
    monkeypatch.setattr("flux_generator_tpu_torch.server.memory.device_hbm_gb", lambda: BUDGET_GB)
    for argv, want in ((["--quantize", "--w8a8"], (True, "ops")), (["--w8a8", "fused"], (False, "fused")),
                       ([], (False, None))):
        with pytest.raises(_Stop):
            main(["--port", str(find_available_port("127.0.0.1", 49600))] + argv)
        assert (made["api"].quantize, made["api"].w8a8) == want and made["host"] == "127.0.0.1"
    with pytest.raises(SystemExit):
        main(["--w8a8", "xla"])


# ------------------------------------------------------------ the UI (tests/test_ui_smoke.py)


def test_ui_is_the_jax_page_with_the_backend_renamed():
    mine, theirs = ui.INDEX_HTML.splitlines(), jui.INDEX_HTML.splitlines()
    assert len(mine) == len(theirs)
    differ = [(a, b) for a, b in zip(mine, theirs) if a != b]
    assert len(differ) == 2 and all("TPU" in b and "TPU" not in a for a, b in differ)
    assert "H100" in ui.INDEX_HTML and "TPU" not in ui.INDEX_HTML + ui.DOCS_HTML
    assert len(ui.DOCS_HTML.splitlines()) == len(jui.DOCS_HTML.splitlines())


def test_every_ui_fetch_round_trips(server):
    fetched = set(re.findall(r"fetch\('([^']+)'", ui.INDEX_HTML))
    assert fetched and not fetched - set(jsmoke.UI_FETCH_PAYLOADS)
    for path in sorted(fetched):
        status, data = (_get(server + path) if jsmoke.UI_FETCH_PAYLOADS[path] is None
                        else _post(server + path, jsmoke.UI_FETCH_PAYLOADS[path]))
        assert status == 200, path
        if path.endswith(("txt2img", "img2img")):
            assert data["images"] and isinstance(data["images"][0], str)
        elif path.endswith("music"):
            assert data["audio"].startswith("data:audio/wav;base64,")
            assert "duration_s" in data and "sampling_rate" in data
        elif path.endswith("progress"):
            assert "progress" in data


def test_every_js_element_id_exists_in_html():
    used = set(re.findall(r"getElementById\('([^']+)'\)", ui.INDEX_HTML))
    used |= {f"panel-{t}" for t in re.findall(r'data-tab="([^"]+)"', ui.INDEX_HTML)}
    assert not used - set(re.findall(r'id="([^"]+)"', ui.INDEX_HTML))


def test_ui_model_options_are_valid_server_models(server):
    selects = re.findall(r"<select[^>]*id=\"(img-model|i2i-model)\"(.*?)</select>", ui.INDEX_HTML, re.S)
    assert selects
    titles = {m["title"] for m in _get(server + "/sdapi/v1/sd-models")[1]}
    for _, body in selects:
        options = re.findall(r'<option value="([^"]+)"', body)
        assert options and set(options) <= titles


def test_js_response_field_contract(server):
    """Every field the page's JS reads off a 200 response is in the port
    server's response to the JS-shaped payload (the page's JS is the JAX
    package's, so the JAX test's extraction applies)."""
    segments = jsmoke._fetch_segments()
    assert segments
    for path, fields, anyof in segments:
        payload = jsmoke.UI_FETCH_PAYLOADS[path]
        status, data = _get(server + path) if payload is None else _post(server + path, payload)
        assert status == 200
        assert not {f for f in fields - anyof if f not in data}, (path, sorted(data))
        if anyof:
            assert anyof & set(data)


# ------------------------------------------------------------ tiny port pipelines over HTTP


class _Tok:
    """Token rows for both the Flux tokenizers (`encode`) and SD's
    (`tokenize`) of the tiny configs: ids below 64, EOS 63."""

    eos_token = 63

    def encode(self, texts, **kw):
        texts = [texts] if isinstance(texts, str) else texts
        return [[1 + sum(map(ord, t)) % 50, 2, 3, 0] for t in texts]

    def tokenize(self, text):
        return [1] + [3 + sum(map(ord, w)) % 57 for w in text.split()] + [63]


def _flux_factory(name):
    g = torch.Generator().manual_seed(0)
    pipe = FluxPipeline.random_init(name, tiny=True, dtype=torch.float32, generator=g)
    pipe.clip_tokenizer = pipe.t5_tokenizer = _Tok()
    return pipe


def _sd_factory(name):
    cls = StableDiffusionXL if "xl" in name else StableDiffusion
    pipe = cls.random_init(tiny=True, dtype=torch.float32, generator=torch.Generator().manual_seed(1))
    pipe.tokenizers = [_Tok()] * len(pipe.clip_cfgs)
    return pipe


def _music_factory():
    pipe = MusicGenPipeline.random_init(generator=torch.Generator().manual_seed(2))
    pipe.tokenizer = _Tok()
    return pipe


@pytest.fixture(scope="module")
def real():
    api = get_app(_flux_factory, _sd_factory, budget_gb=BUDGET_GB)
    api._music_factory = _music_factory
    srv = Server(api, "127.0.0.1", 0)
    srv.start_background()
    yield api, f"http://127.0.0.1:{srv.port}"
    srv.shutdown()


def _last(gen):
    x = None
    for x in gen:
        pass
    return x


def test_served_flux_image_equals_the_direct_call(real):
    """A short solo Flux request takes generate_images_fused."""
    api, base = real
    _, data = _post(base + "/sdapi/v1/txt2img", {"prompt": "a cat", "model": "flux-schnell", "width": 64,
                                                  "height": 64, "steps": 2, "seed": 7})
    pipe = api.pipeline
    want = _png_data_url(pipe.generate_images_fused("a cat", num_steps=2, guidance=4.0, latent_size=(8, 8),
                                                    seed=7)[0].numpy())
    assert data["images"] == [want]
    _, again = _post(base + "/sdapi/v1/txt2img", {"prompt": "a cat", "model": "flux-schnell", "width": 64,
                                                   "height": 64, "steps": 2, "seed": 7})
    assert again["images"] == [want]


@pytest.mark.parametrize("model,steps,cfg", [("stabilityai/stable-diffusion-2-1-base", 3, 4.0),
                                             ("stabilityai/sdxl-turbo", 2, 0.0)])
def test_served_sd_image_equals_the_direct_call(real, model, steps, cfg):
    api, base = real
    _, data = _post(base + "/sdapi/v1/txt2img", {"prompt": "a red fox", "model": model, "width": 64, "height": 64,
                                                  "steps": steps, "cfg_scale": cfg, "seed": 5})
    pipe = api.sd_pipeline
    lat = _last(pipe.generate_latents_batch(["a red fox"], [5], num_steps=steps, cfg_weight=cfg, negative_text="",
                                            latent_size=(8, 8)))
    assert data["images"] == [_png_data_url(_fetch_u8(pipe, lat)[0])]


def test_served_img2img_equals_the_direct_call(real):
    api, base = real
    init = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    _, data = _post(base + "/sdapi/v1/img2img", {"prompt": "a boat", "model": "stabilityai/sdxl-turbo",
                                                  "init_images": ["data:image/png;base64," + _png(init)],
                                                  "width": 64, "height": 64, "steps": 2, "cfg_scale": 0.0,
                                                  "denoising_strength": 0.5, "seed": 9})
    pipe = api.sd_pipeline
    arr = torch.from_numpy(init).float() / 255 * 2 - 1
    lat = _last(pipe.generate_latents_from_image(arr, "a boat", strength=0.5, num_steps=2, cfg_weight=0.0,
                                                 negative_text="", seed=9))
    assert data["images"] == [_png_data_url(_fetch_u8(pipe, lat)[0])]


def test_served_music_equals_the_direct_call(real):
    api, base = real
    _, data = _post(base + "/api/music", {"prompt": "happy rock", "max_steps": 12, "top_k": 4, "seed": 3})
    pipe = api.music_pipeline
    wav = pipe.generate_requests([{"text": "happy rock", "max_steps": 12, "seed": 3}], top_k=4)[0]
    buf = io.BytesIO()
    save_audio(buf, wav.numpy(), pipe.sampling_rate)
    assert data["audio"] == data["audios"][0] == "data:audio/wav;base64," + base64.b64encode(buf.getvalue()).decode()
    assert data["sampling_rate"] == pipe.sampling_rate


def _coalesced(api, base, path, payloads):
    """Send the payloads while the generation lock is held, so that they
    wait as one group."""
    results = [None] * len(payloads)

    def fire(i):
        results[i] = _post(base + path, payloads[i])[1]

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(payloads))]
    api._gen_lock.acquire()
    try:
        for t in threads:
            t.start()
        for _ in range(400):
            with api._batch_lock:
                if sum(len(v) for v in api._pending.values()) == len(payloads):
                    break
            time.sleep(0.05)
    finally:
        api._gen_lock.release()
    for t in threads:
        t.join()
    return results


@pytest.mark.parametrize("model,steps", [("flux-schnell", 3), ("stabilityai/stable-diffusion-2-1-base", 2)])
def test_concurrent_requests_coalesce_without_padding(real, model, steps):
    """Three waiting requests run as one batch of their 3 seeds (no pad
    to a bucket), with three distinct images."""
    api, base = real
    payloads = [{"prompt": f"p{s}", "model": model, "width": 64, "height": 64, "steps": steps, "seed": s}
                for s in (1, 2, 3)]
    seen = []
    pipe = api.init_pipeline(model)
    real_batch = pipe.generate_latents_batch

    def record(texts, seeds, **kw):
        seen.append(list(seeds))
        return real_batch(texts, seeds, **kw)

    pipe.generate_latents_batch = record
    try:
        results = _coalesced(api, base, "/sdapi/v1/txt2img", payloads)
    finally:
        del pipe.generate_latents_batch
    assert len(seen) == 1 and sorted(seen[0]) == [1, 2, 3]
    assert all("coalesced batch 3" in r["info"] for r in results)
    assert len({r["images"][0] for r in results}) == 3


def test_concurrent_music_requests_coalesce(real):
    api, base = real
    groups = []
    real_batch = api._run_music_batch

    def record(items, *args):
        groups.append(len(items))
        return real_batch(items, *args)

    api._run_music_batch = record
    try:
        results = _coalesced(api, base, "/api/music", [
            {"prompt": f"tune {i}", "max_steps": 8 + 4 * i, "top_k": 4, "seed": i} for i in range(4)])
    finally:
        del api._run_music_batch
    assert groups == [4]
    assert len({r["audio"] for r in results}) == 4
    assert [r["duration_s"] for r in results] == sorted(r["duration_s"] for r in results)


def test_multi_image_request_via_coalescer(real):
    _, base = real
    _, data = _post(base + "/sdapi/v1/txt2img", {"prompt": "multi", "model": "flux-schnell", "width": 64,
                                                  "height": 64, "steps": 1, "seed": 11, "batch_size": 2,
                                                  "n_iter": 2})
    assert len(data["images"]) == 4 and len(set(data["images"])) == 4


def test_live_preview_during_generation(real):
    """A 6-step Flux request sets previews at steps 1-5 (every steps // 4)."""
    api, base = real
    previews = []
    real_set = api.progress.set_preview

    def record(url):
        previews.append(url)
        real_set(url)

    api.progress.set_preview = record
    try:
        _post(base + "/sdapi/v1/txt2img", {"prompt": "x", "model": "flux-schnell", "width": 64, "height": 64,
                                            "steps": 6, "seed": 1})
    finally:
        del api.progress.set_preview
    assert previews and all(p.startswith("data:image/png;base64,") for p in previews)


def test_flux_batch_pads_clip_rows_of_different_lengths():
    """Coalesced Flux prompts whose CLIP rows differ in length (the BPE
    tokenizer pads a row to its own length) batch, and each pooled CLIP
    vector keeps its solo value: rows are padded with EOS, which the causal
    encoder pools before."""

    class _Varied(_Tok):
        def encode(self, texts, **kw):
            texts = [texts] if isinstance(texts, str) else texts
            return [[1] + [2 + len(w) % 40 for w in t.split()] + [63] for t in texts]

    pipe = _flux_factory("flux-schnell")
    pipe.clip_tokenizer = _Varied()
    texts = ["a", "a much longer prompt of words"]
    cond = next(pipe.generate_latents_batch(texts, [1, 2], num_steps=1, latent_size=(8, 8)))
    vec = cond[4]  # the protocol's conditioning tuple (x_t, x_ids, txt, txt_ids, vec)
    assert vec.shape[0] == 2
    for i, text in enumerate(texts):
        solo = pipe.prepare_conditioning(1, *pipe.tokenize(text))[2]
        torch.testing.assert_close(vec[i:i + 1], solo, rtol=1e-5, atol=1e-5)


def test_serving_a_request_loads_nothing_of_the_jax_package():
    """A served request (a tiny port pipeline behind the HTTP server, the
    memory planner's footprints and a WAV answer) imports no jax and no
    module of the JAX package."""
    import subprocess
    import sys

    from tests.test_torch_bridge import _LOADED, REPO

    code = (
        "import sys, json, urllib.request, torch\n"
        "from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline\n"
        "from flux_generator_tpu_torch.server.app import get_app\n"
        "from flux_generator_tpu_torch.server.httpd import Server\n"
        "from flux_generator_tpu_torch.server.memory import footprints_gb\n"
        "class Tok:\n"
        "    def encode(self, text, pad=True): return [1, 2, 3]\n"
        "def music():\n"
        "    p = MusicGenPipeline.random_init(device='cpu'); p.tokenizer = Tok(); return p\n"
        "api = get_app(budget_gb=80.0); api._music_factory = music\n"
        "srv = Server(api, '127.0.0.1', 0); srv.start_background()\n"
        "req = urllib.request.Request(f'http://127.0.0.1:{srv.port}/api/music', json.dumps({'prompt': 'x', "
        "'max_steps': 8, 'top_k': 4}).encode(), {'Content-Type': 'application/json'})\n"
        "assert json.loads(urllib.request.urlopen(req).read())['audio'].startswith('data:audio/wav')\n"
        "srv.shutdown()\n"
        "assert footprints_gb()\n"
        f"loaded = {_LOADED}\n"
        "assert not loaded, loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
