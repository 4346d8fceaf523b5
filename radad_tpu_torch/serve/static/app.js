// RADAD-TPU demo frontend. Same capabilities as the reference SPA
// (static/app.js in the upstream repo): catalog with search + inline
// playback, file upload, MediaRecorder mic capture, predict with
// recorded > uploaded > selected priority, neighbor table rendering.
"use strict";

let catalogItems = [];
let selectedFile = null;
let uploadedFile = null;
let recordedBlob = null;
let mediaRecorder = null;
let recChunks = [];

const $ = (sel) => document.querySelector(sel);
const esc = (s) =>
  String(s).replace(/[&<>"']/g, (c) =>
    ({ "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;" }[c]));

async function loadDbInfo() {
  try {
    const r = await fetch("/api/dbinfo");
    const d = await r.json();
    $("#dbinfo").textContent = d.has_index
      ? `index: ${d.ntotal} reference clips`
      : "index: not loaded";
  } catch (e) {
    $("#dbinfo").textContent = "index: unavailable";
  }
}

async function loadCatalog() {
  const r = await fetch("/api/list");
  const d = await r.json();
  catalogItems = d.items || [];
  renderCatalog();
}

function renderCatalog() {
  const q = ($("#search").value || "").toLowerCase();
  const tbody = $("#catalog tbody");
  tbody.innerHTML = "";
  catalogItems
    .filter((it) =>
      !q ||
      it.file.toLowerCase().includes(q) ||
      it.speaker.toLowerCase().includes(q) ||
      it.label.toLowerCase().includes(q))
    .forEach((it) => {
      const tr = document.createElement("tr");
      if (selectedFile === it.file) tr.classList.add("selected");
      tr.innerHTML = `
        <td><input type="radio" name="sel" ${selectedFile === it.file ? "checked" : ""}></td>
        <td>${esc(it.file)}</td>
        <td>${esc(it.speaker)}</td>
        <td><span class="label ${it.label === "spoof" ? "spoof" : "bona"}">${esc(it.label)}</span></td>
        <td>${esc(it.duration)}</td>
        <td><button class="play" data-url="${esc(it.url)}">▶</button></td>`;
      tr.addEventListener("click", () => {
        selectedFile = it.file;
        renderCatalog();
      });
      tr.querySelector(".play").addEventListener("click", (ev) => {
        ev.stopPropagation();
        playUrl(it.url);
      });
      tbody.appendChild(tr);
    });
}

let currentAudio = null;
function playUrl(url) {
  if (currentAudio) currentAudio.pause();
  currentAudio = new Audio(url);
  currentAudio.play();
}

// ---------- upload ----------
$("#file-input").addEventListener("change", (ev) => {
  uploadedFile = ev.target.files[0] || null;
  $("#upload-status").textContent = uploadedFile
    ? `Chosen: ${uploadedFile.name} (${Math.round(uploadedFile.size / 1024)} kB)`
    : "No file chosen.";
});

// ---------- recording ----------
$("#rec-btn").addEventListener("click", async () => {
  if (mediaRecorder && mediaRecorder.state === "recording") {
    mediaRecorder.stop();
    return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({ audio: true });
    recChunks = [];
    mediaRecorder = new MediaRecorder(stream);
    mediaRecorder.ondataavailable = (e) => recChunks.push(e.data);
    mediaRecorder.onstop = () => {
      recordedBlob = new Blob(recChunks, { type: mediaRecorder.mimeType || "audio/webm" });
      const url = URL.createObjectURL(recordedBlob);
      const pb = $("#rec-playback");
      pb.src = url;
      pb.hidden = false;
      $("#rec-status").textContent = `Recorded ${Math.round(recordedBlob.size / 1024)} kB.`;
      $("#rec-btn").textContent = "● Start recording";
      stream.getTracks().forEach((t) => t.stop());
    };
    mediaRecorder.start();
    $("#rec-btn").textContent = "■ Stop";
    $("#rec-status").textContent = "Recording…";
  } catch (e) {
    $("#rec-status").textContent = `Mic unavailable: ${e.message}`;
  }
});

// ---------- predict ----------
$("#predict-btn").addEventListener("click", async () => {
  const fd = new FormData();
  if (recordedBlob) {
    fd.append("file", recordedBlob, "recording.webm");
  } else if (uploadedFile) {
    fd.append("file", uploadedFile, uploadedFile.name);
  } else if (selectedFile) {
    fd.append("filename", selectedFile);
  } else {
    showError("Choose a catalog file, upload, or record first.");
    return;
  }
  $("#predict-btn").disabled = true;
  $("#error").hidden = true;
  $("#result").hidden = true;
  try {
    const r = await fetch("/api/predict", { method: "POST", body: fd });
    const d = await r.json();
    if (!d.ok) throw new Error(d.error || "prediction failed");
    renderResult(d);
  } catch (e) {
    showError(e.message);
  } finally {
    $("#predict-btn").disabled = false;
  }
});

function renderResult(d) {
  const v = $("#verdict");
  v.textContent = d.prediction;
  v.className = "badge " + (d.prediction === "spoof" ? "spoof" : "bona");
  $("#prob").textContent = `P(spoof) = ${(d.probability_spoof ?? d.probability).toFixed(4)}`;
  const tbody = $("#neighbors tbody");
  tbody.innerHTML = "";
  (d.neighbors || []).forEach((n) => {
    const tr = document.createElement("tr");
    const dist = n.distance == null ? "—" : n.distance.toFixed(3);
    tr.innerHTML = `
      <td>${esc(n.file)}</td><td>${esc(n.speaker)}</td>
      <td><span class="label ${n.label === "spoof" ? "spoof" : "bona"}">${esc(n.label)}</span></td>
      <td>${esc(n.duration)}</td><td>${esc(dist)}</td>
      <td>${n.url ? `<button class="play" data-url="${esc(n.url)}">▶</button>` : ""}</td>`;
    const btn = tr.querySelector(".play");
    if (btn) btn.addEventListener("click", () => playUrl(n.url));
    tbody.appendChild(tr);
  });
  $("#result").hidden = false;
}

function showError(msg) {
  const e = $("#error");
  e.textContent = msg;
  e.hidden = false;
}

$("#search").addEventListener("input", renderCatalog);
loadDbInfo();
loadCatalog();
