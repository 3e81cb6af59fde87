"""Browser demo UI (the port's own copy of `emotivoice_tpu/serving/demo.py`).

Parity target: reference `demo_page.py` / `demo_page_databaker.py`
(Streamlit: speaker select, emotion prompt, text box, synthesize button,
inline audio player — reference lines 61-176). Streamlit is a heavyweight
optional dependency; here the demo is a single self-contained HTML page
served by the same process as the API (GET /), driving
POST /v1/audio/speech from the browser. No extra server, no extra deps.
"""

from __future__ import annotations

from typing import Iterable

_PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>EmotiVoice demo</title>
<style>
  :root {{ color-scheme: light dark; }}
  body {{ font-family: system-ui, sans-serif; max-width: 640px;
         margin: 2rem auto; padding: 0 1rem; line-height: 1.5; }}
  h1 {{ font-size: 1.4rem; }}
  label {{ display: block; margin-top: 1rem; font-weight: 600; }}
  select, input, textarea {{ width: 100%; box-sizing: border-box;
         padding: .5rem; margin-top: .25rem; font: inherit; }}
  textarea {{ min-height: 5rem; }}
  button {{ margin-top: 1.25rem; padding: .6rem 1.5rem; font: inherit;
         cursor: pointer; }}
  #status {{ margin-top: 1rem; color: gray; min-height: 1.5em; }}
  audio {{ width: 100%; margin-top: 1rem; }}
  .row {{ display: flex; gap: 1rem; }}
  .row > div {{ flex: 1; }}
</style>
</head>
<body>
<h1>EmotiVoice &mdash; emotional text-to-speech</h1>
<div class="row">
  <div>
    <label for="voice">Speaker</label>
    <select id="voice">{voice_options}</select>
  </div>
  <div>
    <label for="speed">Speed</label>
    <input id="speed" type="number" value="1.0" min="0.25" max="4" step="0.05">
  </div>
</div>
<label for="prompt">Emotion / style prompt</label>
<input id="prompt" value="{default_prompt}"
       placeholder="e.g. Happy, Sad, 高兴, or any free-form description">
<label for="text">Text (Chinese, English, or mixed)</label>
<textarea id="text">{default_text}</textarea>
<button id="go">Synthesize</button>
<div id="status"></div>
<audio id="player" controls style="display:none"></audio>
<script>
const el = id => document.getElementById(id);
el('go').onclick = async () => {{
  el('status').textContent = 'synthesizing…';
  el('go').disabled = true;
  try {{
    const r = await fetch('/v1/audio/speech', {{
      method: 'POST',
      headers: {{'Content-Type': 'application/json'}},
      body: JSON.stringify({{
        input: el('text').value,
        voice: el('voice').value,
        prompt: el('prompt').value,
        speed: parseFloat(el('speed').value) || 1.0,
        response_format: 'wav',
      }}),
    }});
    if (!r.ok) throw new Error(await r.text());
    const blob = await r.blob();
    const p = el('player');
    p.src = URL.createObjectURL(blob);
    p.style.display = 'block';
    p.play();
    el('status').textContent = 'done';
  }} catch (e) {{
    el('status').textContent = 'error: ' + e.message;
  }} finally {{
    el('go').disabled = false;
  }}
}};
</script>
</body>
</html>
"""


def render_demo_page(
    voices: Iterable[str],
    default_prompt: str = "Happy",
    default_text: str = "Hello, this is EmotiVoice.",
) -> str:
    options = "\n".join(
        f'<option value="{v}">{v}</option>' for v in voices
    )
    return _PAGE.format(
        voice_options=options,
        default_prompt=default_prompt,
        default_text=default_text,
    )
