// Employees workspace — list / register / archive / hard-delete / audit
// against the employee blueprint's contracts (reference app/api/employee.py:
// /register :89, GET / :222, /update :341, /delete :396,
// /cleanup-duplicates :461, /audit-logs :500).

let EMP = { companyId: null, employees: [], selectedId: null, dt: null };

async function loadEmpCompanies() {
  const data = await api(API_CONFIG.ENDPOINTS.COMPANIES);
  const sel = $('#company-select');
  clear(sel);
  sel.append(el('option', { value: '' }, '— select a company —'));
  for (const c of data.companies || []) {
    sel.append(el('option', { value: c._id }, c.companyName || c._id));
  }
}

async function loadEmployees() {
  if (!EMP.companyId) { EMP.employees = []; renderEmployees(); return; }
  EMP.employees = await api(
    `${API_CONFIG.ENDPOINTS.EMPLOYEES}/?companyId=${EMP.companyId}` +
    `&fetchImages=true&fetchEmbeddings=true`);
  renderEmployees();
}

function embBadge(model, info) {
  const status = (info && info.status) || 'none';
  return el('span', { class: `chip badge-${status}`, title: model },
    `${model.replace('_v1', '').replace('buffalo_l', 'arcface')}: ${status}`);
}

function renderEmployees() {
  const tbody = $('#employees-tbody');
  // filter/sort/pagination live in the shared dataTable controller
  // (table.js), driven by the page's #employee-filter search box
  if (!EMP.dt) {
    EMP.dt = dataTable(tbody.closest('table'), {
      searchInput: $('#employee-filter'), noSort: [6],
    });
  }
  clear(tbody);
  $('#employee-count').textContent = `${EMP.employees.length}`;
  for (const e of EMP.employees) {
    const tr = el('tr', {
      style: 'cursor:pointer',
      onclick: () => { EMP.selectedId = e.employeeId; renderEmployees(); },
    },
      el('td', {}, e.employeeId || ''),
      el('td', {}, e.employeeName || ''),
      el('td', {}, e.employeeEmail || ''),
      el('td', {}, e.employeeDesignation || ''),
      el('td', {}, el('span', { class: 'chip' }, e.status || 'active')),
      el('td', {}, Object.entries(e.employeeEmbeddings || {})
        .map(([m, info]) => embBadge(m, info))),
      el('td', {},
        el('button', {
          class: 'small', onclick: (ev) => { ev.stopPropagation(); archiveEmployee(e); },
        }, 'Archive'),
        el('button', {
          class: 'small danger',
          onclick: (ev) => { ev.stopPropagation(); hardDeleteEmployee(e); },
        }, 'Delete'),
      ),
    );
    if (EMP.selectedId === e.employeeId) tr.classList.add('selected');
    tbody.append(tr);
  }
  EMP.dt.update();
  renderEmployeeDetail();
}

function renderEmployeeDetail() {
  const box = $('#employee-detail');
  clear(box);
  const e = EMP.employees.find(x => x.employeeId === EMP.selectedId);
  if (!e) {
    box.append(el('div', { class: 'muted' }, 'Select an employee.'));
    return;
  }
  const thumbs = el('div', { class: 'pose-thumbs' });
  for (const [pose, url] of Object.entries(e.employeeImages || {})) {
    const img = el('img', { src: url, alt: pose, title: pose });
    thumbs.append(img);
  }
  box.append(
    el('h3', {}, e.employeeName || e.employeeId),
    thumbs,
    el('dl', { class: 'kv' },
      el('dt', {}, 'Employee ID'), el('dd', {}, e.employeeId || ''),
      el('dt', {}, 'Email'), el('dd', {}, e.employeeEmail || '—'),
      el('dt', {}, 'Mobile'), el('dd', {}, e.employeeMobile || '—'),
      el('dt', {}, 'Designation'), el('dd', {}, e.employeeDesignation || '—'),
      el('dt', {}, 'Status'), el('dd', {}, e.status || 'active'),
      el('dt', {}, 'Blacklisted'), el('dd', {}, String(!!e.blacklisted)),
      el('dt', {}, 'Embeddings'),
      el('dd', {}, Object.entries(e.employeeEmbeddings || {}).map(([m, info]) =>
        el('div', {}, embBadge(m, info), ' ',
          info.downloadUrl
            ? el('a', { href: info.downloadUrl }, 'download') : ''))),
    ),
  );
}

async function deleteEmployee(e, mode) {
  try {
    await api(`${API_CONFIG.ENDPOINTS.EMPLOYEES}/delete`, {
      method: 'DELETE',
      json: { employeeId: e.employeeId, companyId: EMP.companyId, mode },
    });
    toast(mode === 'soft' ? 'Employee archived' : 'Employee deleted');
    loadEmployees();
  } catch (err) { toast(err.message, true); }
}

function archiveEmployee(e) {
  if (!confirm(`Archive "${e.employeeName || e.employeeId}"?`)) return;
  deleteEmployee(e, 'soft');
}

function hardDeleteEmployee(e) {
  if (!confirm(`PERMANENTLY delete "${e.employeeName || e.employeeId}" ` +
               'including images and embeddings?')) return;
  deleteEmployee(e, 'hard');
}

async function registerEmployee(ev) {
  ev.preventDefault();
  if (!EMP.companyId) { toast('Select a company first', true); return; }
  const form = new FormData();
  form.append('employeeId', $('#reg-id').value.trim());
  form.append('employeeName', $('#reg-name').value.trim());
  form.append('companyId', EMP.companyId);
  if ($('#reg-email').value) form.append('employeeEmail', $('#reg-email').value.trim());
  if ($('#reg-mobile').value) form.append('employeeMobile', $('#reg-mobile').value.trim());
  if ($('#reg-designation').value)
    form.append('employeeDesignation', $('#reg-designation').value.trim());
  for (const pose of ['center', 'left', 'right']) {
    const f = $(`#reg-${pose}`).files[0];
    if (!f) { toast(`Missing ${pose} image`, true); return; }
    form.append(pose, f);
  }
  try {
    const r = await fetch(`${API_CONFIG.BASE_URL}/employees/register`,
                          { method: 'POST', body: form });
    const body = await r.json();
    if (!r.ok) throw new Error(body.error || r.statusText);
    toast(`Registered — enrollment ${JSON.stringify(body.embeddingStatus)}`);
    closeModal('register-modal');
    $('#register-form').reset();
    loadEmployees();
  } catch (err) { toast(err.message, true); }
}

async function cleanupDuplicates() {
  if (!EMP.companyId) { toast('Select a company first', true); return; }
  try {
    const r = await api(`${API_CONFIG.ENDPOINTS.EMPLOYEES}/cleanup-duplicates`,
                        { method: 'POST', json: { companyId: EMP.companyId } });
    toast(r.message || 'Cleanup done');
    loadEmployees();
  } catch (err) { toast(err.message, true); }
}

let AUDIT_DT = null;

async function loadAuditLogs() {
  const token = $('#audit-token').value.trim();
  if (!token) { toast('Auth token required', true); return; }
  try {
    const logs = await api(`${API_CONFIG.ENDPOINTS.EMPLOYEES}/audit-logs`,
                           { headers: { 'X-Auth-Token': token } });
    const tbody = $('#audit-tbody');
    if (!AUDIT_DT) {
      AUDIT_DT = dataTable(tbody.closest('table'), {
        placeholder: 'Search audit log...', pageSize: 25,
      });
    }
    clear(tbody);
    for (const log of logs) {
      tbody.append(el('tr', {},
        el('td', {}, fmtDate(log.timestamp)),
        el('td', {}, log.action || ''),
        el('td', {}, log.employeeId || ''),
        el('td', {}, String(log.companyId || '')),
      ));
    }
    AUDIT_DT.update();
  } catch (err) { toast(err.message, true); }
}

document.addEventListener('DOMContentLoaded', async () => {
  if (document.body.dataset.page !== 'employees') return;
  try { await loadEmpCompanies(); } catch (e) { toast(e.message, true); }
  $('#company-select').addEventListener('change', async (ev) => {
    EMP.companyId = ev.target.value || null;
    EMP.selectedId = null;
    try { await loadEmployees(); }
    catch (e) { EMP.employees = []; renderEmployees(); toast(e.message, true); }
  });
  $('#register-btn').addEventListener('click', () => {
    if (!EMP.companyId) { toast('Select a company first', true); return; }
    openModal('register-modal');
  });
  $('#register-form').addEventListener('submit', registerEmployee);
  $('#cleanup-btn').addEventListener('click', cleanupDuplicates);
  $('#audit-load-btn').addEventListener('click', loadAuditLogs);
  $all('[data-close]').forEach(b =>
    b.addEventListener('click', () => closeModal(b.dataset.close)));
});
