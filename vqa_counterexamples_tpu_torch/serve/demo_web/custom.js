// Demo client logic (role of reference demo_web/js/custom.js): POST
// {visual, question} to the server, render answers + attention maps.
"use strict";

let imageB64 = null;

// Checkpoint hot-swap: populate the selector from GET /checkpoints (hidden
// when the server has no --ckpt_root), switch weights via POST /checkpoint.
(async () => {
  try {
    const resp = await fetch(window.location.origin + "/checkpoints");
    const data = await resp.json();
    const list = data.checkpoints || [];
    if (!list.length) return;
    const row = document.getElementById("ckptrow");
    const sel = document.getElementById("ckpt");
    list.forEach((c) => {
      const o = document.createElement("option");
      o.value = c.name;
      o.textContent = c.name + (c.best ? " (best)" : "") +
        (c.epoch != null ? " @epoch " + c.epoch : "");
      sel.appendChild(o);
    });
    row.hidden = false;
    sel.addEventListener("change", async () => {
      const status = document.getElementById("ckptstatus");
      status.textContent = "loading...";
      try {
        const r = await fetch(window.location.origin + "/checkpoint", {
          method: "POST",
          headers: { "Content-Type": "application/json" },
          body: JSON.stringify({ name: sel.value }),
        });
        const d = await r.json();
        if (d.error) throw new Error(d.error);
        status.textContent = "loaded";
      } catch (e) {
        status.textContent = "failed: " + e.message;
      }
    });
  } catch (e) {
    /* server without checkpoint registry: keep the row hidden */
  }
})();

document.getElementById("file").addEventListener("change", (ev) => {
  const file = ev.target.files[0];
  if (!file) return;
  const reader = new FileReader();
  reader.onload = () => {
    imageB64 = reader.result;
    const img = document.getElementById("preview");
    img.src = imageB64;
    img.hidden = false;
  };
  reader.readAsDataURL(file);
});

document.getElementById("ask").addEventListener("click", async () => {
  const question = document.getElementById("question").value.trim();
  const errEl = document.getElementById("error");
  errEl.textContent = "";
  if (!imageB64 || !question) {
    errEl.textContent = "Pick an image and type a question first.";
    return;
  }
  try {
    const resp = await fetch(window.location.origin, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ visual: imageB64, question }),
    });
    const data = await resp.json();
    if (data.error) throw new Error(data.error);
    const tbody = document.querySelector("#answers tbody");
    tbody.innerHTML = "";
    data.ans.forEach((a, i) => {
      const row = document.createElement("tr");
      row.innerHTML = `<td>${a}</td><td>${(data.val[i] * 100).toFixed(1)}%</td>`;
      tbody.appendChild(row);
    });
    document.getElementById("answers").hidden = false;
    const attDiv = document.getElementById("attmaps");
    attDiv.innerHTML = "";
    (data.att || []).forEach((png) => {
      const img = document.createElement("img");
      img.src = "data:image/png;base64," + png;
      attDiv.appendChild(img);
    });
  } catch (e) {
    errEl.textContent = "Request failed: " + e.message;
  }
});
