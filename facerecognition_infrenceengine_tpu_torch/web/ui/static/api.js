// Tiny fetch-based API client + DOM helpers (replaces the reference's
// jQuery $.ajax calls in app/static/js/app.js with vanilla fetch).

// Some endpoints return MongoDB extended JSON (the reference served entity
// reads through bson json_util): ids as {"$oid": "..."} and datetimes as
// {"$date": epoch_ms}. Normalize those to plain strings so UI code can
// treat every id as a string and every date as an ISO string.
function ejson(value) {
  if (Array.isArray(value)) return value.map(ejson);
  if (value && typeof value === 'object') {
    const keys = Object.keys(value);
    if (keys.length === 1 && keys[0] === '$oid') return value.$oid;
    if (keys.length === 1 && keys[0] === '$date') {
      return new Date(value.$date).toISOString();
    }
    const out = {};
    for (const k of keys) out[k] = ejson(value[k]);
    return out;
  }
  return value;
}

async function api(path, opts = {}) {
  const url = API_CONFIG.BASE_URL + path;
  const init = { method: opts.method || 'GET', headers: {} };
  if (opts.json !== undefined) {
    init.headers['Content-Type'] = 'application/json';
    init.body = JSON.stringify(opts.json);
  } else if (opts.form !== undefined) {
    init.body = opts.form; // FormData — browser sets the boundary
  }
  if (opts.headers) Object.assign(init.headers, opts.headers);
  const resp = await fetch(url, init);
  let body = null;
  const text = await resp.text();
  try { body = ejson(text ? JSON.parse(text) : null); } catch (_) { body = text; }
  if (!resp.ok) {
    const msg = (body && (body.error || body.message)) || resp.statusText;
    const err = new Error(msg);
    err.status = resp.status;
    err.body = body;
    throw err;
  }
  return body;
}

// ---- DOM helpers -----------------------------------------------------
function $(sel, root) { return (root || document).querySelector(sel); }
function $all(sel, root) { return Array.from((root || document).querySelectorAll(sel)); }

function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === 'class') node.className = v;
    else if (k.startsWith('on') && typeof v === 'function') {
      node.addEventListener(k.slice(2), v);
    } else if (v !== null && v !== undefined) node.setAttribute(k, v);
  }
  for (const c of children.flat()) {
    if (c === null || c === undefined) continue;
    node.append(c.nodeType ? c : document.createTextNode(String(c)));
  }
  return node;
}

function clear(node) { while (node.firstChild) node.removeChild(node.firstChild); return node; }

let _toastTimer = null;
function toast(msg, isError) {
  let t = $('#toast');
  if (!t) { t = el('div', { id: 'toast', class: 'toast' }); document.body.append(t); }
  t.textContent = msg;
  t.style.background = isError ? 'var(--danger)' : '#18213a';
  t.classList.add('show');
  clearTimeout(_toastTimer);
  _toastTimer = setTimeout(() => t.classList.remove('show'), 3200);
}

function openModal(id) { $('#' + id).classList.add('open'); }
function closeModal(id) { $('#' + id).classList.remove('open'); }

function qsParam(name) {
  return new URLSearchParams(window.location.search).get(name);
}

function fmtDate(iso) {
  if (!iso) return '—';
  const d = new Date(iso);
  return isNaN(d) ? String(iso) : d.toLocaleString();
}
