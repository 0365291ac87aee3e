/* Task manager UI (reference: static/js/app.js): Drive file pickers with
 * folder filters, job submission, 3 s batch polling with per-job fallback,
 * per-user localStorage persistence with 30-day retention, ETA estimation
 * from progress rate, cancel + result views, visibility save/resume hooks. */
"use strict";

const POLL_INTERVAL_MS = 3000;
const RETENTION_MS = 30 * 24 * 3600 * 1000;
const RECORDINGS_FOLDER = "WearNote_Recordings";
const DOCUMENTS_FOLDER = "WearNote_Recordings/Documents";

/* ---------------------------------------------------------------- dialogs */
/* First-party modal + toast (the reference uses SweetAlert2 for its cancel
 * confirm / success / error dialogs, app.js:1839-1944 — this UI ships no
 * CDN dependencies, so the same flows are ~60 lines of our own). */

const UI = {
  confirm({ title, text, confirmLabel = "OK", cancelLabel = "Keep", danger = false }) {
    return new Promise((resolve) => {
      const overlay = document.createElement("div");
      overlay.className = "modal-overlay";
      const box = document.createElement("div");
      box.className = "modal";
      const h = document.createElement("h3");
      h.textContent = title;
      const p = document.createElement("p");
      p.textContent = text;
      const row = document.createElement("div");
      row.className = "modal-actions";
      const keep = document.createElement("button");
      keep.className = "btn btn-ghost";
      keep.textContent = cancelLabel;
      const go = document.createElement("button");
      go.className = danger ? "btn btn-danger" : "btn btn-primary";
      go.textContent = confirmLabel;
      row.append(keep, go);
      box.append(h, p, row);
      overlay.appendChild(box);
      const close = (v) => { overlay.remove(); document.removeEventListener("keydown", onKey); resolve(v); };
      const onKey = (ev) => { if (ev.key === "Escape") close(false); };
      keep.onclick = () => close(false);
      go.onclick = () => close(true);
      overlay.onclick = (ev) => { if (ev.target === overlay) close(false); };
      document.addEventListener("keydown", onKey);
      document.body.appendChild(overlay);
      keep.focus(); // reference focuses the safe button (focusCancel: true)
    });
  },

  toast(message, kind = "info", ms = 3000) {
    let host = document.getElementById("toast-host");
    if (!host) {
      host = document.createElement("div");
      host.id = "toast-host";
      document.body.appendChild(host);
    }
    const t = document.createElement("div");
    t.className = `toast toast-${kind}`;
    t.textContent = message;
    host.appendChild(t);
    setTimeout(() => { t.classList.add("toast-out"); setTimeout(() => t.remove(), 300); }, ms);
  },
};

/* ------------------------------------------------------------------ store */

const TaskStore = {
  key() {
    const uid = (Auth.user && Auth.user.id) || "anon";
    return `aptpu_tasks_${uid}`;
  },
  load() {
    try {
      const raw = JSON.parse(localStorage.getItem(this.key()) || "[]");
      const cutoff = Date.now() - RETENTION_MS;
      return raw.filter((t) => (t.createdAt || 0) > cutoff);
    } catch (e) {
      return [];
    }
  },
  save(tasks) {
    try { localStorage.setItem(this.key(), JSON.stringify(tasks)); } catch (e) { /* quota */ }
  },
};

/* ---------------------------------------------------------------- manager */

const Tasks = {
  tasks: [],            // {jobId, name, status, progress, message, createdAt, result, history:[{t,progress}]}
  pollTimer: null,
  sseStreams: {},       // jobId -> EventSource (SSE preferred, polling fallback)
  sseLast: {},          // jobId -> ms timestamp of the last SSE frame
  misses: {},           // jobId -> consecutive polls where the server had no such job

  init() {
    this.tasks = TaskStore.load();
    this.renderAll();
    this.active().forEach((t) => this.subscribe(t.jobId));
    this.startPolling();
    document.addEventListener("visibilitychange", () => {
      if (document.hidden) TaskStore.save(this.tasks);
      else this.pollNow();
    });
    window.addEventListener("beforeunload", () => TaskStore.save(this.tasks));
  },

  byId(jobId) { return this.tasks.find((t) => t.jobId === jobId); },

  async create(fileId, fileName, attachmentIds) {
    const body = { file_id: fileId };
    if (attachmentIds && attachmentIds.length) body.attachment_file_ids = attachmentIds;
    const resp = await fetch("/api/process", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    const data = await resp.json();
    if (!data.success) throw new Error(data.error || "submit failed");
    const task = {
      jobId: data.job_id, name: fileName, status: data.job_status || "pending",
      progress: 0, message: "Queued", createdAt: Date.now(), result: null, history: [],
    };
    this.tasks.unshift(task);
    TaskStore.save(this.tasks);
    this.renderAll();
    this.subscribe(task.jobId);
    this.pollNow();
    return task;
  },

  subscribe(jobId) {
    if (typeof EventSource === "undefined" || this.sseStreams[jobId]) return;
    try {
      const es = new EventSource(`/api/job/${jobId}/events`);
      es.onmessage = (ev) => {
        this.sseLast[jobId] = Date.now();
        try {
          const job = JSON.parse(ev.data);
          this.applyUpdate(jobId, job);
        } catch (e) { /* malformed frame: polling still covers us */ }
      };
      es.addEventListener("end", () => {
        es.close(); delete this.sseStreams[jobId]; delete this.sseLast[jobId];
        // a stream that ended while the task is still active means the
        // job vanished server-side (pruned/restart): let polling confirm
        // and finalize instead of spinning forever
        this.pollNow();
      });
      es.onerror = () => { es.close(); delete this.sseStreams[jobId]; delete this.sseLast[jobId]; };
      this.sseStreams[jobId] = es;
      this.sseLast[jobId] = Date.now();
    } catch (e) { /* SSE unavailable: polling fallback */ }
  },

  applyUpdate(jobId, job) {
    const task = this.byId(jobId);
    if (!task || !job) return;
    task.status = job.status;
    task.progress = job.progress;
    task.message = job.status === "failed" ? (job.error || job.message) : (job.message || "");
    task.history.push({ t: Date.now(), progress: job.progress });
    if (task.history.length > 20) task.history.shift();
    if (job.status === "completed") task.result = job.result || null;
    TaskStore.save(this.tasks);
    this.renderTask(task);
  },

  active() {
    return this.tasks.filter((t) => ["queued", "pending", "processing"].includes(t.status));
  },

  startPolling() {
    if (this.pollTimer) clearInterval(this.pollTimer);
    this.pollTimer = setInterval(() => this.pollNow(), POLL_INTERVAL_MS);
  },

  async pollNow() {
    // polling covers tasks without a live SSE stream, plus streams that
    // have gone SILENT (a buffering proxy can hold an open EventSource
    // with no frames ever delivered — onerror never fires)
    const now = Date.now();
    const active = this.active().filter(
      (t) => !this.sseStreams[t.jobId]
        || now - (this.sseLast[t.jobId] || 0) > 4 * POLL_INTERVAL_MS
    );
    if (!active.length) return;
    const ids = active.map((t) => t.jobId);
    let jobs = null;
    const unknown = new Set();  // network/server errors: NOT evidence the job is gone
    try {
      const resp = await fetch("/api/jobs/status/batch", {
        method: "POST",
        headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ job_ids: ids }),
      });
      if (resp.ok) jobs = (await resp.json()).jobs;
    } catch (e) { /* fall through to per-job */ }
    if (jobs === null) {
      // fallback: per-job GETs in batches of 3 (reference behaviour)
      jobs = {};
      for (let i = 0; i < ids.length; i += 3) {
        await Promise.all(ids.slice(i, i + 3).map(async (id) => {
          try {
            const r = await fetch(`/api/job/${id}`);
            if (r.ok) jobs[id] = (await r.json()).job;
            else if (r.status !== 404) unknown.add(id);  // 5xx: inconclusive
          } catch (e) { unknown.add(id); /* offline: inconclusive */ }
        }));
      }
    }
    let changed = false;
    for (const task of active) {
      const job = jobs[task.jobId];
      if (!job) {
        if (unknown.has(task.jobId)) { this.renderTask(task); continue; }
        // the server ANSWERED and doesn't know this job (pruned, restart
        // with a volatile store): after a few consecutive misses finalize
        // the task instead of polling a dead id every 3 s for 30 days
        this.misses[task.jobId] = (this.misses[task.jobId] || 0) + 1;
        if (this.misses[task.jobId] >= 3) {
          task.status = "failed";
          task.message = "Job no longer exists on the server";
          this.closeStream(task.jobId);
          changed = true;
          this.renderTask(task);
        }
        continue;
      }
      delete this.misses[task.jobId];
      if (job.status !== task.status || job.progress !== task.progress || job.message !== task.message) {
        task.status = job.status;
        task.progress = job.progress;
        task.message = job.message || "";
        task.history.push({ t: Date.now(), progress: job.progress });
        if (task.history.length > 20) task.history.shift();
        if (job.status === "completed") task.result = job.result || null;
        if (job.status === "failed") task.message = job.error || task.message;
        changed = true;
      }
      this.renderTask(task);
    }
    if (changed) TaskStore.save(this.tasks);
  },

  eta(task) {
    const h = task.history;
    const terminal = ["completed", "failed", "cancelled"].includes(task.status);
    if (terminal || h.length < 2 || task.progress >= 100) return "";
    const first = h[0], last = h[h.length - 1];
    const dp = last.progress - first.progress;
    const dt = (last.t - first.t) / 1000;
    if (dp <= 0 || dt <= 0) return "";
    const remaining = (100 - last.progress) * (dt / dp);
    if (!isFinite(remaining) || remaining > 3600 * 4) return "";
    const m = Math.floor(remaining / 60), s = Math.round(remaining % 60);
    return m > 0 ? `~${m}m ${s}s left` : `~${s}s left`;
  },

  async cancel(jobId) {
    const ok = await UI.confirm({
      title: "Cancel this task?",
      text: "The job stops at the next stage boundary. This cannot be undone.",
      confirmLabel: "Cancel task",
      cancelLabel: "Keep running",
      danger: true,
    });
    if (!ok) return;
    try {
      const resp = await fetch(`/api/job/${jobId}/cancel`, { method: "POST" });
      const data = await resp.json();
      if (data.success) {
        const task = this.byId(jobId);
        if (task) {
          task.status = "cancelled";
          task.message = "Cancelled";
          TaskStore.save(this.tasks);
          this.renderTask(task);
        }
        UI.toast("Task cancelled", "ok");
      } else {
        UI.toast("Cancel failed: " + (data.error || "unknown"), "err", 5000);
      }
    } catch (e) {
      UI.toast("Cancel failed: " + e, "err", 5000);
    }
    this.pollNow();
  },

  closeStream(jobId) {
    // release the server's capped SSE slot (removed/reloaded tasks would
    // otherwise hold it until job completion)
    const es = this.sseStreams[jobId];
    if (es) { es.close(); delete this.sseStreams[jobId]; delete this.sseLast[jobId]; }
  },

  closeAllStreams() {
    Object.keys(this.sseStreams).forEach((id) => this.closeStream(id));
  },

  remove(jobId) {
    this.closeStream(jobId);
    this.tasks = this.tasks.filter((t) => t.jobId !== jobId);
    TaskStore.save(this.tasks);
    this.renderAll();
  },

  async viewResult(jobId) {
    let task = this.byId(jobId);
    if (task && !task.result) {
      try {
        const resp = await fetch(`/api/jobs/${jobId}/result`);
        if (resp.ok) task.result = (await resp.json()).result;
      } catch (e) { /* show what we have */ }
    }
    const card = document.getElementById("result-card");
    const body = document.getElementById("result-body");
    const r = (task && task.result) || {};
    body.innerHTML = "";
    const add = (label, value) => {
      if (!value) return;
      const row = document.createElement("div");
      row.className = "result-row";
      row.innerHTML = `<strong>${label}</strong>`;
      const span = document.createElement("span");
      span.textContent = value;
      row.appendChild(span);
      body.appendChild(row);
    };
    if (r.diarizer && r.diarizer.startsWith("untrained")) {
      // random-weight diarizer: speaker labels are meaningless — say so
      // instead of presenting them as real output
      add("⚠ Diarizer", `serving UNTRAINED weights (${r.diarizer.split(":")[1] || ""}) — speaker labels are not meaningful`);
    }
    add("Title", r.title);
    add("Summary", r.summary);
    if (r.todos && r.todos.length) add("Action items", r.todos.join(" · "));
    if (r.identified_speakers) {
      add("Speakers", Object.entries(r.identified_speakers).map(([k, v]) => `${k} → ${v}`).join(", "));
    }
    if (r.rtf_x) add("Speed", `${r.rtf_x}× real-time`);
    if (r.segments && r.segments.length) {
      // full speaker-attributed transcript (the reference UI surfaces it;
      // round-1 review flagged its omission here)
      const row = document.createElement("div");
      row.className = "result-row";
      row.innerHTML = "<strong>Transcript</strong>";
      const box = document.createElement("div");
      box.className = "transcript-box";
      for (const seg of r.segments) {
        const line = document.createElement("div");
        line.className = "transcript-line";
        const t = new Date(Math.max(0, seg.start) * 1000).toISOString().substr(11, 8);
        const who = document.createElement("span");
        who.className = "transcript-speaker";
        who.textContent = `[${t}] ${seg.speaker || ""}`;
        const txt = document.createElement("span");
        txt.textContent = ` ${seg.text}`;
        line.appendChild(who);
        line.appendChild(txt);
        box.appendChild(line);
      }
      row.appendChild(box);
      body.appendChild(row);
    }
    if (r.notion_page_url) {
      const link = document.createElement("a");
      link.href = r.notion_page_url;
      link.target = "_blank";
      link.className = "btn btn-primary";
      link.textContent = "Open Notion page";
      body.appendChild(link);
    }
    card.classList.remove("hidden");
    card.scrollIntoView({ behavior: "smooth" });
  },

  /* ---------------------------------------------------------- rendering */

  statusStyle(status) {
    return {
      pending: ["Pending", "badge-wait"],
      queued: ["Queued", "badge-wait"],
      processing: ["Processing", "badge-run"],
      completed: ["Completed", "badge-ok"],
      failed: ["Failed", "badge-err"],
      cancelled: ["Cancelled", "badge-muted"],
    }[status] || [status, "badge-muted"];
  },

  renderAll() {
    const list = document.getElementById("task-list");
    list.innerHTML = "";
    if (!this.tasks.length) {
      list.innerHTML = '<div class="empty">No tasks yet</div>';
      return;
    }
    for (const task of this.tasks) {
      const node = document.getElementById("task-template").content.firstElementChild.cloneNode(true);
      node.dataset.jobId = task.jobId;
      node.querySelector(".btn-cancel").onclick = () => this.cancel(task.jobId);
      node.querySelector(".btn-view").onclick = () => this.viewResult(task.jobId);
      node.querySelector(".btn-remove").onclick = () => this.remove(task.jobId);
      list.appendChild(node);
      this.renderTask(task);
    }
  },

  renderTask(task) {
    const node = document.querySelector(`[data-job-id="${task.jobId}"]`);
    if (!node) return;
    const [label, cls] = this.statusStyle(task.status);
    node.querySelector(".task-name").textContent = task.name || task.jobId.slice(0, 8);
    const badge = node.querySelector(".task-status");
    badge.textContent = label;
    badge.className = `task-status badge ${cls}`;
    node.querySelector(".progress-bar").style.width = `${task.progress || 0}%`;
    node.querySelector(".task-message").textContent = task.message || "";
    node.querySelector(".task-eta").textContent = this.eta(task);
    const done = ["completed", "failed", "cancelled"].includes(task.status);
    node.querySelector(".btn-cancel").classList.toggle("hidden", done);
    node.querySelector(".btn-view").classList.toggle("hidden", task.status !== "completed");
    node.querySelector(".btn-remove").classList.toggle("hidden", !done);
  },
};

/* ----------------------------------------------------------- file pickers */

const Files = {
  selectedAudio: null,
  selectedPdfs: new Set(),

  async refresh() {
    if (!Auth.authenticated) return;
    // shimmer placeholder rows while Drive answers (style.css .skeleton)
    document.getElementById("audio-file-list").innerHTML =
      '<li class="skeleton"></li>'.repeat(3);
    document.getElementById("pdf-file-list").innerHTML =
      '<li class="skeleton"></li>';
    const params = new URLSearchParams();
    if (document.getElementById("recordings-filter").checked) {
      params.set("recordingsFilter", "enabled");
      params.set("recordingsFolderName", RECORDINGS_FOLDER);
    }
    if (document.getElementById("pdf-filter").checked) {
      params.set("pdfFilter", "enabled");
      params.set("pdfFolderName", DOCUMENTS_FOLDER);
    }
    let files = [];
    try {
      const resp = await fetch(`/api/drive/files?${params}`);
      const data = await resp.json();
      if (data.success) files = data.files;
    } catch (e) { /* render empty */ }
    this.render(files);
  },

  render(files) {
    const audioList = document.getElementById("audio-file-list");
    const pdfList = document.getElementById("pdf-file-list");
    audioList.innerHTML = "";
    pdfList.innerHTML = "";
    const audio = files.filter((f) => (f.mimeType || "").startsWith("audio/"));
    const pdfs = files.filter((f) => f.mimeType === "application/pdf");
    if (!audio.length) audioList.innerHTML = '<li class="empty">No audio files found</li>';
    for (const f of audio) {
      const li = document.createElement("li");
      li.textContent = `${f.name}  (${this.fmtSize(f.size)})`;
      li.onclick = () => {
        this.selectedAudio = f;
        audioList.querySelectorAll("li").forEach((x) => x.classList.remove("selected"));
        li.classList.add("selected");
        document.getElementById("process-btn").disabled = false;
        document.getElementById("picker-hint").textContent = f.name;
      };
      audioList.appendChild(li);
    }
    for (const f of pdfs) {
      const li = document.createElement("li");
      li.textContent = f.name;
      li.onclick = () => {
        if (this.selectedPdfs.has(f.id)) { this.selectedPdfs.delete(f.id); li.classList.remove("selected"); }
        else { this.selectedPdfs.add(f.id); li.classList.add("selected"); }
      };
      pdfList.appendChild(li);
    }
  },

  fmtSize(bytes) {
    if (!bytes) return "–";
    const units = ["B", "KB", "MB", "GB"];
    let i = 0, n = bytes;
    while (n >= 1024 && i < units.length - 1) { n /= 1024; i++; }
    return `${n.toFixed(i ? 1 : 0)} ${units[i]}`;
  },
};

/* ------------------------------------------------------------------ wire */

document.addEventListener("DOMContentLoaded", () => {
  Tasks.init();
  document.getElementById("refresh-files").onclick = () => Files.refresh();
  document.getElementById("recordings-filter").onchange = () => Files.refresh();
  document.getElementById("pdf-filter").onchange = () => Files.refresh();
  document.getElementById("recordings-folder-label").textContent = RECORDINGS_FOLDER;
  document.getElementById("pdf-folder-label").textContent = DOCUMENTS_FOLDER;
  document.getElementById("process-btn").onclick = async () => {
    const f = Files.selectedAudio;
    if (!f) return;
    try {
      await Tasks.create(f.id, f.name, [...Files.selectedPdfs]);
      Files.selectedPdfs.clear();
      UI.toast("Task submitted", "ok");
    } catch (e) {
      UI.toast("Failed to submit: " + e.message, "err", 5000);
    }
  };
  document.addEventListener("auth:changed", (ev) => {
    if (ev.detail.authenticated) Files.refresh();
    Tasks.closeAllStreams();
    Tasks.tasks = TaskStore.load();
    Tasks.renderAll();
    // re-subscribe the restored user's active tasks to SSE explicitly —
    // polling never opens streams, so session resume (the normal page
    // load for a logged-in user) otherwise stayed on polling forever
    Tasks.active().forEach((t) => Tasks.subscribe(t.jobId));
    Tasks.pollNow();
  });
});

/* console debug hook (reference: window.debugJobsStatus) */
window.debugJobsStatus = async () => (await fetch("/api/jobs/debug")).json();
