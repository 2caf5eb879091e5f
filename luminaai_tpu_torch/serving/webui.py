"""(The port's copy of luminaai_tpu/serving/webui.py: the same PAGE.)

Built-in chat web UI, served at GET / by the HTTP server.

The reference ships an Electron desktop chat app (ref package.json
"lumina-ai-desktop"; its renderer talks to the Flask backend on :5001 —
docker-compose.dev.yml:12). The app's main.js/renderer sources are absent
from the reference repo, so the parity target is the CONTRACT: a chat
client over the HTTP backend. Here that's a single dependency-free HTML
page speaking the same /v1/chat endpoint — with SSE streaming, sampling
controls, and session stats — so `lumina serve` is a complete chat
deployment with zero extra installs (open the URL in any browser).
"""

PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>LuminaAI TPU Chat</title>
<style>
  :root { --bg:#101419; --panel:#1a2028; --text:#e6e9ee; --dim:#8a94a3;
          --accent:#4f9cf9; --user:#243247; --bot:#1f2733; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--text);
         font:15px/1.5 system-ui, sans-serif; display:flex;
         flex-direction:column; height:100vh; }
  header { padding:10px 16px; background:var(--panel);
           display:flex; gap:16px; align-items:center; }
  header h1 { font-size:16px; margin:0; }
  header .stat { color:var(--dim); font-size:12px; }
  #log { flex:1; overflow-y:auto; padding:16px; }
  .msg { max-width:72ch; margin:8px 0; padding:10px 14px;
         border-radius:10px; white-space:pre-wrap; }
  .user { background:var(--user); margin-left:auto; }
  .bot  { background:var(--bot); }
  .meta { color:var(--dim); font-size:11px; margin-top:4px; }
  form { display:flex; gap:8px; padding:12px 16px; background:var(--panel); }
  textarea { flex:1; resize:none; background:var(--bg); color:var(--text);
             border:1px solid #2a3340; border-radius:8px; padding:10px;
             font:inherit; height:52px; }
  button { background:var(--accent); border:0; color:#fff; padding:0 22px;
           border-radius:8px; font:inherit; cursor:pointer; }
  button:disabled { opacity:.5; cursor:default; }
  details { padding:4px 16px; background:var(--panel); color:var(--dim);
            font-size:13px; }
  details input { width:70px; background:var(--bg); color:var(--text);
                  border:1px solid #2a3340; border-radius:4px;
                  padding:2px 6px; margin:0 12px 0 4px; }
</style>
</head>
<body>
<header>
  <h1>LuminaAI TPU</h1>
  <span class="stat" id="model"></span>
  <span class="stat" id="speed"></span>
</header>
<div id="log"></div>
<details>
  <summary>sampling</summary>
  max_new_tokens <input id="maxnew" type="number" value="256">
  temperature <input id="temp" type="number" step="0.05" value="0.8">
  top_p <input id="topp" type="number" step="0.05" value="0.9">
</details>
<form id="f">
  <textarea id="box" placeholder="Message… (Enter to send)"></textarea>
  <button id="send" type="submit">Send</button>
</form>
<script>
const log = document.getElementById('log');
const box = document.getElementById('box');
const send = document.getElementById('send');
const history = [];
let token = sessionStorage.getItem('lumina_token') || null;

async function login() {
  // Secure-mode servers gate /v1/chat behind /v1/auth Bearer tokens.
  const user = prompt('username');
  if (user === null) return false;
  const pass = prompt('password');
  if (pass === null) return false;
  const r = await fetch('/v1/auth', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({user: user, password: pass}),
  });
  if (!r.ok) { alert('login failed'); return false; }
  token = (await r.json()).token;
  sessionStorage.setItem('lumina_token', token);
  return true;
}

fetch('/health').then(r => r.json()).then(h => {
  const m = h.model || {};
  document.getElementById('model').textContent =
    `${m.num_layers}L x ${m.hidden_size}h` + (m.moe ? ' MoE' : '');
}).catch(() => {});

function add(cls, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + cls;
  d.textContent = text;
  log.appendChild(d);
  log.scrollTop = log.scrollHeight;
  return d;
}

async function chat(text) {
  history.push({role: 'user', content: text});
  add('user', text);
  const bot = add('bot', '');
  send.disabled = true;
  try {
    const body = {
      messages: history, stream: true,
      max_new_tokens: +document.getElementById('maxnew').value || 256,
      temperature: +document.getElementById('temp').value,
      top_p: +document.getElementById('topp').value,
    };
    const hdrs = {'Content-Type': 'application/json'};
    if (token) hdrs['Authorization'] = 'Bearer ' + token;
    let r = await fetch('/v1/chat', {
      method: 'POST', headers: hdrs, body: JSON.stringify(body),
    });
    if (r.status === 401) {          // secure mode: log in, retry once
      if (await login()) {
        hdrs['Authorization'] = 'Bearer ' + token;
        r = await fetch('/v1/chat', {
          method: 'POST', headers: hdrs, body: JSON.stringify(body),
        });
      }
    }
    if (!r.ok || !(r.headers.get('content-type') || '')
        .startsWith('text/event-stream')) {
      const err = await r.json().catch(() => ({}));
      bot.textContent = 'error: ' + (err.error || r.status);
      return;
    }
    const reader = r.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let idx;
      while ((idx = buf.indexOf('\\n\\n')) >= 0) {
        const frame = buf.slice(0, idx); buf = buf.slice(idx + 2);
        if (!frame.startsWith('data: ')) continue;
        const data = frame.slice(6);
        if (data === '[DONE]') continue;
        const ev = JSON.parse(data);
        if (ev.error) { bot.textContent += '\\n[error: ' + ev.error + ']'; }
        else if (ev.done) {
          // The done frame's reply is authoritative (full decode).
          if (ev.reply !== undefined) bot.textContent = ev.reply;
          history.push({role: 'assistant', content: bot.textContent});
          const tps = ev.latency_s > 0
            ? (ev.tokens / ev.latency_s).toFixed(1) : '?';
          document.getElementById('speed').textContent =
            `${ev.tokens} tok in ${ev.latency_s}s (${tps} tok/s)`;
          const meta = document.createElement('div');
          meta.className = 'meta';
          meta.textContent = `${ev.tokens} tokens - ${ev.stopped}`;
          bot.appendChild(meta);
        } else if (ev.delta) {
          bot.textContent += ev.delta;
          log.scrollTop = log.scrollHeight;
        }
      }
    }
  } catch (e) {
    bot.textContent += '\\n[connection error: ' + e + ']';
  } finally {
    send.disabled = false;
    box.focus();
  }
}

document.getElementById('f').addEventListener('submit', e => {
  e.preventDefault();
  const t = box.value.trim();
  if (t) { box.value = ''; chat(t); }
});
box.addEventListener('keydown', e => {
  if (e.key === 'Enter' && !e.shiftKey) {
    e.preventDefault();
    document.getElementById('f').requestSubmit();
  }
});
box.focus();
</script>
</body>
</html>
"""
