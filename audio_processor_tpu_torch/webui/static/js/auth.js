/* Auth state handling (reference: static/js/auth.js): checks
 * /api/auth/status, renders user chip, wires login/logout with redirect-loop
 * guards, clears per-user localStorage on logout. */
"use strict";

const Auth = {
  authenticated: false,
  user: null,

  async checkStatus() {
    try {
      const resp = await fetch("/api/auth/status");
      const data = await resp.json();
      this.authenticated = !!data.authenticated;
      this.user = data.user || null;
    } catch (e) {
      this.authenticated = false;
      this.user = null;
    }
    this.render();
    document.dispatchEvent(
      new CustomEvent("auth:changed", { detail: { authenticated: this.authenticated, user: this.user } })
    );
    return this.authenticated;
  },

  render() {
    const name = document.getElementById("user-name");
    const avatar = document.getElementById("user-avatar");
    const loginBtn = document.getElementById("login-btn");
    const logoutBtn = document.getElementById("logout-btn");
    if (!name) return; // not on the main page
    if (this.authenticated && this.user) {
      name.textContent = this.user.name || this.user.email || this.user.id;
      name.classList.remove("hidden");
      // avatar with CORS fallback (reference: static/js/auth.js:177-229):
      // googleusercontent URLs get a small fixed size, the request sends no
      // referrer (Google 403s some referrered loads), and a failed load
      // swaps in an inline placeholder instead of vanishing
      let pic = this.user.picture || "";
      if (pic.includes("googleusercontent.com")) pic = pic.replace(/=s\d+-c$/, "=s64-c");
      avatar.referrerPolicy = "no-referrer";
      avatar.onerror = () => {
        avatar.onerror = null;
        avatar.src = this.placeholderAvatar();
        avatar.style.opacity = "0.7";
      };
      avatar.src = pic || this.placeholderAvatar();
      avatar.classList.remove("hidden");
      logoutBtn.classList.remove("hidden");
      loginBtn.classList.add("hidden");
    } else {
      name.classList.add("hidden");
      avatar.classList.add("hidden");
      logoutBtn.classList.add("hidden");
      loginBtn.classList.remove("hidden");
    }
  },

  placeholderAvatar() {
    // inline SVG: initial letter on an accent disc — no image asset needed
    const ch = ((this.user && (this.user.name || this.user.email)) || "?")[0].toUpperCase();
    const svg = `<svg xmlns="http://www.w3.org/2000/svg" width="64" height="64">` +
      `<circle cx="32" cy="32" r="32" fill="#4f8cff"/>` +
      `<text x="32" y="42" font-size="30" font-family="sans-serif" fill="#fff" text-anchor="middle">${ch}</text></svg>`;
    return "data:image/svg+xml," + encodeURIComponent(svg);
  },

  async logout() {
    try { await fetch("/api/auth/logout", { method: "POST" }); } catch (e) { /* best effort */ }
    // purge THIS user's task history only — stores are deliberately keyed
    // per user (aptpu_tasks_<uid>), and a shared browser must not lose
    // other accounts' 30-day histories on someone else's logout
    const uid = (this.user && this.user.id) || "anon";
    const mine = [`aptpu_tasks_${uid}`, "aptpu_tasks_anon"];
    const doomed = [];
    for (let i = 0; i < localStorage.length; i++) {
      const key = localStorage.key(i);
      if (key && mine.includes(key)) doomed.push(key);
    }
    doomed.forEach((k) => localStorage.removeItem(k));
    this.authenticated = false;
    this.user = null;
    if (!location.pathname.startsWith("/login")) location.href = "/login";
  },

  init() {
    const loginBtn = document.getElementById("login-btn");
    const logoutBtn = document.getElementById("logout-btn");
    if (loginBtn) loginBtn.onclick = () => { location.href = "/api/auth/google"; };
    if (logoutBtn) logoutBtn.onclick = () => this.logout();
    this.checkStatus();
  },
};

document.addEventListener("DOMContentLoaded", () => Auth.init());
