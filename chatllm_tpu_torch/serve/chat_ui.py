"""Built-in chat page served at `/` (a copy of the JAX package's
`serve/chat_ui.py`; reference: bindings/server.nim handle_index :622-632
serves scripts/chat_ui.html, overridable with `--ui FILE`).

This page is an ORIGINAL minimal implementation of the same surface — a
single self-contained HTML chat client that streams from
`/v1/chat/completions` over SSE — not a copy of the reference's page.
Users who want the reference's richer UI can pass it straight through:
`--ui /path/to/chat_ui.html` (drop-in, same serving semantics incl.
`.gz` handling).
"""

CHAT_UI_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>chatllm_tpu</title>
<style>
  :root { --bg:#111416; --panel:#1b2023; --me:#2b5278; --ai:#24292e;
          --text:#e8eaed; --dim:#9aa0a6; --accent:#4f8cc9; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--text);
         font:15px/1.5 system-ui, sans-serif; display:flex;
         flex-direction:column; height:100vh; }
  header { padding:10px 16px; background:var(--panel);
           border-bottom:1px solid #000; display:flex; gap:12px;
           align-items:baseline; }
  header h1 { font-size:16px; margin:0; }
  header span { color:var(--dim); font-size:12px; }
  #log { flex:1; overflow-y:auto; padding:16px; }
  .msg { max-width:72ch; margin:6px 0; padding:8px 12px;
         border-radius:10px; white-space:pre-wrap;
         overflow-wrap:anywhere; }
  .me  { background:var(--me); margin-left:auto; }
  .ai  { background:var(--ai); }
  .meta { color:var(--dim); font-size:12px; margin:2px 4px; }
  form { display:flex; gap:8px; padding:12px 16px; background:var(--panel);
         border-top:1px solid #000; }
  textarea { flex:1; resize:none; background:var(--bg); color:var(--text);
             border:1px solid #333; border-radius:8px; padding:8px;
             font:inherit; height:3em; }
  button { background:var(--accent); color:#fff; border:0;
           border-radius:8px; padding:0 18px; font:inherit;
           cursor:pointer; }
  button:disabled { opacity:.5; cursor:default; }
</style>
</head>
<body>
<header><h1>chatllm_tpu</h1><span id="model">loading model…</span></header>
<div id="log"></div>
<form id="f">
  <textarea id="in" placeholder="Message — Enter to send, Shift+Enter for newline"></textarea>
  <button id="send" type="submit">Send</button>
</form>
<script>
"use strict";
const log = document.getElementById("log");
const input = document.getElementById("in");
const send = document.getElementById("send");
const history = [];
let model = "default";

fetch("/v1/models").then(r => r.json()).then(j => {
  model = (j.data && j.data[0] && j.data[0].id) || "default";
  document.getElementById("model").textContent = model;
}).catch(() => {});

function bubble(cls, text) {
  const d = document.createElement("div");
  d.className = "msg " + cls;
  d.textContent = text;
  log.appendChild(d);
  log.scrollTop = log.scrollHeight;
  return d;
}

async function ask(text) {
  history.push({role: "user", content: text});
  bubble("me", text);
  const out = bubble("ai", "");
  send.disabled = true;
  try {
    const resp = await fetch("/v1/chat/completions", {
      method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({model, messages: history, stream: true}),
    });
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = "", acc = "";
    for (;;) {
      const {value, done} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      for (;;) {
        const nl = buf.indexOf("\\n");
        if (nl < 0) break;
        const line = buf.slice(0, nl).trim();
        buf = buf.slice(nl + 1);
        if (!line.startsWith("data:")) continue;
        const payload = line.slice(5).trim();
        if (payload === "[DONE]") continue;
        try {
          const j = JSON.parse(payload);
          const delta = j.choices && j.choices[0] && j.choices[0].delta;
          if (delta && delta.content) {
            acc += delta.content;
            out.textContent = acc;
            log.scrollTop = log.scrollHeight;
          }
        } catch (e) { /* partial frame */ }
      }
    }
    history.push({role: "assistant", content: acc});
  } catch (e) {
    out.textContent = "[error] " + e;
    out.className = "msg meta";
  } finally {
    send.disabled = false;
    input.focus();
  }
}

document.getElementById("f").addEventListener("submit", ev => {
  ev.preventDefault();
  const t = input.value.trim();
  if (!t || send.disabled) return;
  input.value = "";
  ask(t);
});
input.addEventListener("keydown", ev => {
  if (ev.key === "Enter" && !ev.shiftKey) {
    ev.preventDefault();
    document.getElementById("f").requestSubmit();
  }
});
input.focus();
</script>
</body>
</html>
"""
