"""Self-contained web UI (the port's copy of flux_generator_tpu/server/ui.py,
with only the backend's name changed): its own HTML/JS, so the server has no
UI dependencies. Two tabs — Image Generation and Music Generation — with the
same element ids, fetch routes and model presets, and a stats panel per
generation, driven by the FluxAPI endpoints."""

INDEX_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>Flux Generator (H100)</title>
<style>
  :root { color-scheme: dark; }
  body { font-family: system-ui, sans-serif; margin: 0; background: #111318; color: #e6e6e6; }
  header { padding: 14px 22px; background: #1a1d24; border-bottom: 1px solid #2a2e37; }
  h1 { font-size: 18px; margin: 0; }
  .tabs { display: flex; gap: 6px; padding: 10px 22px 0; }
  .tab { padding: 8px 18px; background: #1a1d24; border: 1px solid #2a2e37; border-bottom: none;
         border-radius: 8px 8px 0 0; cursor: pointer; }
  .tab.active { background: #232733; font-weight: 600; }
  .panel { display: none; padding: 20px 22px; }
  .panel.active { display: flex; gap: 24px; flex-wrap: wrap; }
  .controls { flex: 1 1 340px; max-width: 460px; display: flex; flex-direction: column; gap: 10px; }
  .output { flex: 2 1 480px; }
  label { font-size: 13px; color: #9aa1ad; display: block; margin-bottom: 3px; }
  input, select, textarea { width: 100%; box-sizing: border-box; padding: 8px; border-radius: 6px;
         border: 1px solid #2a2e37; background: #0d0f13; color: #e6e6e6; }
  textarea { min-height: 70px; resize: vertical; }
  .row { display: flex; gap: 10px; }
  .row > div { flex: 1; }
  button { padding: 10px 16px; border-radius: 8px; border: none; background: #3b82f6;
           color: white; font-weight: 600; cursor: pointer; }
  button:disabled { background: #444; }
  #image-out img { max-width: 100%; border-radius: 8px; border: 1px solid #2a2e37; }
  .stats { margin-top: 12px; font-size: 13px; color: #9aa1ad; white-space: pre-line;
           background: #1a1d24; border-radius: 8px; padding: 10px 14px; }
  progress { width: 100%; height: 8px; }
</style>
</head>
<body>
<header><h1>⚡ Flux Generator — H100/PyTorch</h1></header>
<div class="tabs">
  <div class="tab active" data-tab="image">Image Generation</div>
  <div class="tab" data-tab="img2img">Image to Image</div>
  <div class="tab" data-tab="music">Music Generation</div>
</div>

<div class="panel active" id="panel-image">
  <div class="controls">
    <div><label>Prompt</label><textarea id="img-prompt">A majestic mountain at sunset</textarea></div>
    <div><label>Model</label>
      <select id="img-model">
        <option value="flux-schnell">Flux Schnell (Fast)</option>
        <option value="flux-dev">Flux Dev (High Quality)</option>
        <option value="stabilityai/stable-diffusion-2-1-base">SD 2.1 Base</option>
        <option value="stabilityai/sdxl-turbo">SDXL Turbo</option>
      </select></div>
    <div class="row">
      <div><label>Width</label><input id="img-width" type="number" value="512" step="16"></div>
      <div><label>Height</label><input id="img-height" type="number" value="512" step="16"></div>
    </div>
    <div class="row">
      <div><label>Steps</label><input id="img-steps" type="number" value="2"></div>
      <div><label>Guidance</label><input id="img-cfg" type="number" value="4.0" step="0.1"></div>
      <div><label>Seed (-1 = random)</label><input id="img-seed" type="number" value="-1"></div>
    </div>
    <button id="img-go">Generate Image</button>
    <progress id="img-progress" value="0" max="1" hidden></progress>
  </div>
  <div class="output">
    <div id="image-out"></div>
    <div class="stats" id="img-stats">Ready.</div>
  </div>
</div>

<div class="panel" id="panel-img2img">
  <div class="controls">
    <div><label>Source image</label><input id="i2i-file" type="file" accept="image/*"></div>
    <div><label>Prompt</label><textarea id="i2i-prompt">a watercolor painting</textarea></div>
    <div><label>Model</label>
      <select id="i2i-model">
        <option value="stabilityai/stable-diffusion-2-1-base">SD 2.1 Base</option>
        <option value="stabilityai/sdxl-turbo">SDXL Turbo</option>
        <option value="flux-schnell">Flux Schnell (Fast)</option>
        <option value="flux-dev">Flux Dev (High Quality)</option>
      </select></div>
    <div class="row">
      <div><label>Strength</label><input id="i2i-strength" type="number" value="0.75" step="0.05" min="0" max="1"></div>
      <div><label>Steps</label><input id="i2i-steps" type="number" value="50"></div>
      <div><label>Guidance</label><input id="i2i-cfg" type="number" value="7.5" step="0.1"></div>
    </div>
    <button id="i2i-go">Transform Image</button>
  </div>
  <div class="output">
    <div id="i2i-out"></div>
    <div class="stats" id="i2i-stats">Ready.</div>
  </div>
</div>

<div class="panel" id="panel-music">
  <div class="controls">
    <div><label>Prompt</label><textarea id="mus-prompt">happy rock with electric guitar</textarea></div>
    <div><label>Examples</label>
      <select id="mus-example">
        <option value="">— pick an example —</option>
        <option>happy rock with electric guitar</option>
        <option>energetic EDM with heavy bass</option>
        <option>sad jazz piano ballad</option>
        <option>epic orchestral film score</option>
        <option>lo-fi hip hop beat to relax to</option>
        <option>classical string quartet in a minor key</option>
      </select></div>
    <div class="row">
      <div><label>Max steps (50/s ≈ audio len)</label><input id="mus-steps" type="number" value="500"></div>
      <div><label>Top-k</label><input id="mus-topk" type="number" value="250"></div>
    </div>
    <div class="row">
      <div><label>Temperature</label><input id="mus-temp" type="number" value="1.0" step="0.1"></div>
      <div><label>Guidance</label><input id="mus-cfg" type="number" value="3.0" step="0.5"></div>
    </div>
    <div><label>Samples (one batched loop — extra samples are nearly free)</label>
      <select id="mus-samples"><option>1</option><option>2</option><option>4</option></select></div>
    <button id="mus-go">Generate Music</button>
    <progress id="mus-progress" value="0" max="1" hidden></progress>
  </div>
  <div class="output">
    <audio id="music-out" controls style="width:100%"></audio>
    <div id="music-extra"></div>
    <div class="stats" id="mus-stats">Ready.</div>
  </div>
</div>

<script>
document.querySelectorAll('.tab').forEach(t => t.onclick = () => {
  document.querySelectorAll('.tab').forEach(x => x.classList.remove('active'));
  document.querySelectorAll('.panel').forEach(x => x.classList.remove('active'));
  t.classList.add('active');
  document.getElementById('panel-' + t.dataset.tab).classList.add('active');
});

function pollProgress(bar, previewEl) {
  return setInterval(async () => {
    try {
      const p = await (await fetch('/sdapi/v1/progress')).json();
      bar.hidden = false; bar.value = p.progress;
      // live latent preview (A1111 current_image semantics)
      if (previewEl && p.current_image) {
        previewEl.innerHTML = `<img src="${p.current_image}" style="opacity:.7">`;
      }
    } catch (e) {}
  }, 500);
}

// per-model parameter presets (reference flux_app.py:634-643)
const PRESETS = {
  'flux-schnell': {steps: 2, cfg: 4.0},
  'flux-dev': {steps: 50, cfg: 4.0},
  'stabilityai/stable-diffusion-2-1-base': {steps: 50, cfg: 7.5},
  'stabilityai/sdxl-turbo': {steps: 2, cfg: 0.0},
};
document.getElementById('img-model').onchange = (e) => {
  const p = PRESETS[e.target.value];
  if (p) {
    document.getElementById('img-steps').value = p.steps;
    document.getElementById('img-cfg').value = p.cfg;
  }
};

document.getElementById('img-go').onclick = async () => {
  const btn = document.getElementById('img-go'), stats = document.getElementById('img-stats');
  const bar = document.getElementById('img-progress');
  btn.disabled = true; stats.textContent = 'Generating…';
  const timer = pollProgress(bar, document.getElementById('image-out')); const t0 = performance.now();
  try {
    const body = {
      prompt: document.getElementById('img-prompt').value,
      model: document.getElementById('img-model').value,
      width: +document.getElementById('img-width').value,
      height: +document.getElementById('img-height').value,
      steps: +document.getElementById('img-steps').value || null,
      cfg_scale: +document.getElementById('img-cfg').value,
      seed: +document.getElementById('img-seed').value,
    };
    const r = await fetch('/sdapi/v1/txt2img', {method: 'POST',
      headers: {'Content-Type': 'application/json'}, body: JSON.stringify(body)});
    const data = await r.json();
    if (!r.ok) throw new Error(data.detail || r.status);
    const src = data.images[0].startsWith('data:') ? data.images[0]
      : 'data:image/png;base64,' + data.images[0];
    document.getElementById('image-out').innerHTML = `<img src="${src}">`;
    const serverStats = (data.info || '').split('|')[1] || '';
    stats.textContent = `Total time: ${((performance.now()-t0)/1000).toFixed(1)} s\\n` +
      `Model: ${body.model} · ${body.width}×${body.height} · ${body.steps} steps\\n` +
      serverStats.trim();
  } catch (e) { stats.textContent = 'Error: ' + e.message; }
  clearInterval(timer); bar.hidden = true; btn.disabled = false;
};

document.getElementById('i2i-go').onclick = async () => {
  const btn = document.getElementById('i2i-go'), stats = document.getElementById('i2i-stats');
  const file = document.getElementById('i2i-file').files[0];
  if (!file) { stats.textContent = 'Pick a source image first.'; return; }
  btn.disabled = true; stats.textContent = 'Transforming…';
  const t0 = performance.now();
  try {
    const b64 = await new Promise((res, rej) => {
      const r = new FileReader();
      r.onload = () => res(r.result.split(',')[1]);
      r.onerror = rej;
      r.readAsDataURL(file);
    });
    const body = {
      prompt: document.getElementById('i2i-prompt').value,
      init_images: [b64],
      model: document.getElementById('i2i-model').value,
      denoising_strength: +document.getElementById('i2i-strength').value,
      steps: +document.getElementById('i2i-steps').value,
      cfg_scale: +document.getElementById('i2i-cfg').value,
      width: 512, height: 512,
    };
    const r = await fetch('/sdapi/v1/img2img', {method: 'POST',
      headers: {'Content-Type': 'application/json'}, body: JSON.stringify(body)});
    const data = await r.json();
    if (!r.ok) throw new Error(data.detail || r.status);
    document.getElementById('i2i-out').innerHTML = `<img src="${data.images[0]}">`;
    stats.textContent = `Total time: ${((performance.now()-t0)/1000).toFixed(1)} s`;
  } catch (e) { stats.textContent = 'Error: ' + e.message; }
  btn.disabled = false;
};

document.getElementById('mus-example').onchange = (e) => {
  if (e.target.value) document.getElementById('mus-prompt').value = e.target.value;
};

document.getElementById('mus-go').onclick = async () => {
  const btn = document.getElementById('mus-go'), stats = document.getElementById('mus-stats');
  const bar = document.getElementById('mus-progress');
  btn.disabled = true; stats.textContent = 'Generating…';
  const timer = pollProgress(bar); const t0 = performance.now();
  try {
    const body = {
      prompt: document.getElementById('mus-prompt').value,
      max_steps: +document.getElementById('mus-steps').value,
      top_k: +document.getElementById('mus-topk').value,
      temperature: +document.getElementById('mus-temp').value,
      guidance: +document.getElementById('mus-cfg').value,
      n_samples: +document.getElementById('mus-samples').value,
    };
    const r = await fetch('/api/music', {method: 'POST',
      headers: {'Content-Type': 'application/json'}, body: JSON.stringify(body)});
    const data = await r.json();
    if (!r.ok) throw new Error(data.detail || r.status);
    const urls = data.audios || [data.audio];
    document.getElementById('music-out').src = urls[0];
    const extra = document.getElementById('music-extra');
    extra.innerHTML = '';
    for (const u of urls.slice(1)) {
      const a = document.createElement('audio');
      a.controls = true; a.style.width = '100%'; a.src = u;
      extra.appendChild(a);
    }
    stats.textContent = `Total time: ${((performance.now()-t0)/1000).toFixed(1)} s\\n` +
      `Audio: ${urls.length} sample(s), ${data.duration_s}s @ ${data.sampling_rate} Hz`;
  } catch (e) { stats.textContent = 'Error: ' + e.message; }
  clearInterval(timer); bar.hidden = true; btn.disabled = false;
};
</script>
</body>
</html>
"""

DOCS_HTML = """<!DOCTYPE html>
<html><head><title>API docs</title></head>
<body style="font-family:system-ui;max-width:720px;margin:40px auto">
<h1>Flux Generator (PyTorch, H100) — API</h1>
<ul>
<li><code>POST /sdapi/v1/txt2img</code> — A1111-compatible text→image</li>
<li><code>GET /sdapi/v1/sd-models</code> — model list</li>
<li><code>GET/POST /sdapi/v1/options</code> — options</li>
<li><code>GET /sdapi/v1/progress</code> — live generation progress</li>
<li><code>POST /api/music</code> — MusicGen text→music (WAV data URL)</li>
<li><code>GET /health</code></li>
</ul>
</body></html>
"""
