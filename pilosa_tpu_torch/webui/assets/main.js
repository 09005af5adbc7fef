/* pilosa-tpu console (reference webui/assets/main.js analog, written for
 * this framework's JSON API: /version /schema /status /hosts /index/{i}/query). */
"use strict";

const $ = (id) => document.getElementById(id);

// -- tabs -------------------------------------------------------------------

const TABS = ["console", "cluster", "schema"];
TABS.forEach((name) => {
  $("tab-" + name).addEventListener("click", () => {
    TABS.forEach((t) => {
      $("tab-" + t).classList.toggle("active", t === name);
      $("pane-" + t).classList.toggle("active", t === name);
    });
    if (name === "cluster") loadCluster();
    if (name === "schema") loadSchema();
  });
});

// -- bootstrap --------------------------------------------------------------

async function getJSON(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(await r.text());
  return r.json();
}

async function loadVersion() {
  try {
    const v = await getJSON("/version");
    $("version").textContent = "v" + v.version;
  } catch (e) {
    $("version").textContent = "";
  }
}

async function loadIndexes() {
  const sel = $("index-select");
  const prev = sel.value;
  sel.innerHTML = '<option value="">Select index</option>';
  try {
    const schema = await getJSON("/schema");
    for (const idx of schema.indexes || []) {
      const opt = document.createElement("option");
      opt.value = idx.name;
      opt.textContent = idx.name;
      sel.appendChild(opt);
    }
    sel.value = prev;
  } catch (e) {
    /* server unreachable; leave the placeholder */
  }
}

// -- console ----------------------------------------------------------------

function renderResult(query, body, ms, isError) {
  const div = document.createElement("div");
  div.className = "result" + (isError ? " error" : "");
  const meta = document.createElement("div");
  meta.className = "meta";
  meta.textContent = `${new Date().toLocaleTimeString()}  ${ms.toFixed(1)} ms  ${query}`;
  const pre = document.createElement("div");
  pre.textContent = body;
  div.appendChild(meta);
  div.appendChild(pre);
  $("output").prepend(div);
  while ($("output").childElementCount > 50) $("output").lastChild.remove();
}

async function runQuery() {
  const index = $("index-select").value;
  const query = $("query").value.trim();
  if (!index) return renderResult(query, "select an index first", 0, true);
  if (!query) return;
  const t0 = performance.now();
  try {
    const r = await fetch(`/index/${encodeURIComponent(index)}/query`, {
      method: "POST",
      body: query,
    });
    const text = await r.text();
    const ms = performance.now() - t0;
    $("timing").textContent = ms.toFixed(1) + " ms";
    let pretty = text;
    try {
      pretty = JSON.stringify(JSON.parse(text), null, 2);
    } catch (e) {
      /* leave as-is */
    }
    renderResult(query, pretty, ms, !r.ok);
    if (/^(SetBit|ClearBit|SetRowAttrs|SetColumnAttrs)/.test(query)) loadIndexes();
  } catch (e) {
    renderResult(query, String(e), performance.now() - t0, true);
  }
}

// Query history: Up/Down recall (persisted), like a shell prompt.
const HISTORY_KEY = "pilosa-tpu-history";
let history = [];
try {
  history = JSON.parse(localStorage.getItem(HISTORY_KEY) || "[]");
} catch (e) {
  history = [];
}
let histPos = history.length; // one past the end = "editing a new query"
let histDraft = "";

function pushHistory(q) {
  if (!q || history[history.length - 1] === q) {
    histPos = history.length;
    return;
  }
  history.push(q);
  if (history.length > 100) history = history.slice(-100);
  histPos = history.length;
  try {
    localStorage.setItem(HISTORY_KEY, JSON.stringify(history));
  } catch (e) {
    /* private mode */
  }
}

// Keyword autocomplete: Tab completes the word before the caret against
// the PQL call names and common argument keys; repeated Tab cycles.
const KEYWORDS = [
  "Bitmap(", "Count(", "Intersect(", "Union(", "Difference(", "Xor(",
  "Range(", "TopN(", "SetBit(", "ClearBit(", "SetRowAttrs(",
  "SetColumnAttrs(",
  "rowID=", "columnID=", "frame=", "n=", "field=", "filters=",
  "timestamp=", "start=", "end=", "tanimotoThreshold=", "threshold=",
  "inverse=",
];
let tabMatches = [];
let tabIndex = 0;
let tabStart = -1;

function completeAt(el) {
  const pos = el.selectionStart;
  // Only cycle when the caret still sits right after the previous
  // completion; any other caret position starts a fresh completion.
  const cycling =
    tabMatches.length &&
    tabStart >= 0 &&
    pos === tabStart + tabMatches[tabIndex].length;
  if (cycling) {
    // cycle: replace the previous completion with the next candidate
    tabIndex = (tabIndex + 1) % tabMatches.length;
  } else {
    tabMatches = [];
    tabStart = -1;
    const before = el.value.slice(0, pos);
    const m = before.match(/[A-Za-z]+$/);
    if (!m) return;
    tabStart = pos - m[0].length;
    const word = m[0].toLowerCase();
    tabMatches = KEYWORDS.filter((k) => k.toLowerCase().startsWith(word));
    tabIndex = 0;
    if (!tabMatches.length) {
      tabStart = -1;
      return;
    }
  }
  const cand = tabMatches[tabIndex];
  el.value = el.value.slice(0, tabStart) + cand + el.value.slice(el.selectionStart);
  const caret = tabStart + cand.length;
  el.setSelectionRange(caret, caret);
}

$("run").addEventListener("click", () => {
  pushHistory($("query").value.trim());
  runQuery();
});
$("query").addEventListener("keydown", (ev) => {
  const el = ev.target;
  if ((ev.ctrlKey || ev.metaKey) && ev.key === "Enter") {
    pushHistory(el.value.trim());
    runQuery();
    return;
  }
  if (ev.key === "Tab" && !ev.shiftKey) {
    ev.preventDefault();
    completeAt(el);
    return;
  }
  tabMatches = [];
  tabStart = -1;
  // History only when the caret is on the first/last line (multiline
  // editing keeps normal cursor movement).
  if (ev.key === "ArrowUp" && !el.value.slice(0, el.selectionStart).includes("\n")) {
    if (histPos > 0) {
      if (histPos === history.length) histDraft = el.value;
      histPos -= 1;
      el.value = history[histPos];
      ev.preventDefault();
    }
  } else if (ev.key === "ArrowDown" && !el.value.slice(el.selectionEnd).includes("\n")) {
    if (histPos < history.length) {
      histPos += 1;
      el.value = histPos === history.length ? histDraft : history[histPos];
      ev.preventDefault();
    }
  }
});

// -- cluster ----------------------------------------------------------------

async function loadCluster() {
  const tbody = $("cluster-table").querySelector("tbody");
  tbody.innerHTML = "";
  try {
    const status = await getJSON("/status");
    for (const node of status.status?.cluster?.nodes || []) {
      // Hosts arrive over the unauthenticated gossip channel — render as
      // text, never markup.
      const tr = document.createElement("tr");
      const state = node.state || "UP";
      for (const text of [node.host, node.internalHost || "", state]) {
        const td = document.createElement("td");
        td.textContent = text;
        tr.appendChild(td);
      }
      tr.lastChild.className = `state-${state === "DOWN" ? "DOWN" : "UP"}`;
      tbody.appendChild(tr);
    }
  } catch (e) {
    const tr = document.createElement("tr");
    const td = document.createElement("td");
    td.colSpan = 3;
    td.textContent = String(e);
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
}

// -- schema -----------------------------------------------------------------

async function loadSchema() {
  const tree = $("schema-tree");
  tree.innerHTML = "";
  try {
    const schema = await getJSON("/schema");
    for (const idx of schema.indexes || []) {
      const div = document.createElement("div");
      div.className = "tree-index";
      const name = document.createElement("div");
      name.className = "name";
      name.textContent = idx.name;
      div.appendChild(name);
      for (const fr of idx.frames || []) {
        const fdiv = document.createElement("div");
        fdiv.className = "tree-frame";
        const opts = [];
        if (fr.rowLabel) opts.push("rowLabel=" + fr.rowLabel);
        if (fr.cacheType) opts.push("cache=" + fr.cacheType + ":" + fr.cacheSize);
        if (fr.timeQuantum) opts.push("time=" + fr.timeQuantum);
        if (fr.inverseEnabled) opts.push("inverse");
        fdiv.innerHTML = `${fr.name} <span class="opts">${opts.join("  ")}</span>`;
        div.appendChild(fdiv);
      }
      tree.appendChild(div);
    }
    if (!tree.childElementCount) tree.textContent = "no indexes";
  } catch (e) {
    tree.textContent = String(e);
  }
}

loadVersion();
loadIndexes();
