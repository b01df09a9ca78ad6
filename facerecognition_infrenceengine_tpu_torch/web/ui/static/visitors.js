// Visitors workspace — register / schedule visits / check-in / check-out /
// pass download / QR verification against the visitor blueprint's contracts
// (reference app/api/visitor.py: /register :35, schedule-visit :594,
// check-in :689, check-out :727, lists :765/:791, verify-qr :1018).
// The reference ships no visitor admin page; this one drives the same API
// surface its Postman-style docs describe.

let VIS = {
  companyId: null, visitors: [], visits: [], employees: [],
  dtVisitors: null, dtVisits: null, scheduleVisitorId: null,
};

async function loadVisCompanies() {
  const data = await api(API_CONFIG.ENDPOINTS.COMPANIES);
  const sel = $('#company-select');
  clear(sel);
  sel.append(el('option', { value: '' }, '— select a company —'));
  for (const c of data.companies || []) {
    sel.append(el('option', { value: c._id }, c.companyName || c._id));
  }
}

async function loadVisitorsAll() {
  if (!VIS.companyId) {
    VIS.visitors = []; VIS.visits = []; VIS.employees = [];
    renderVisitors(); renderVisits(); return;
  }
  const [visitors, visits, employees] = await Promise.all([
    api(`${API_CONFIG.ENDPOINTS.VISITORS}?companyId=${VIS.companyId}`),
    api(`${API_CONFIG.ENDPOINTS.VISITORS}/visits?companyId=${VIS.companyId}`),
    api(`${API_CONFIG.ENDPOINTS.EMPLOYEES}/?companyId=${VIS.companyId}`),
  ]);
  VIS.visitors = visitors.visitors || [];
  VIS.visits = visits.visits || [];
  VIS.employees = employees || [];
  const hostSel = $('#sv-host');
  clear(hostSel);
  for (const e of VIS.employees) {
    hostSel.append(el('option', { value: e._id },
      `${e.employeeName || e.employeeId} (${e.employeeId})`));
  }
  renderVisitors();
  renderVisits();
}

function visitorName(visitorId) {
  const v = VIS.visitors.find(x => x._id === visitorId);
  return v ? (v.visitorName || v._id) : String(visitorId || '—');
}

function hostName(hostId) {
  const e = VIS.employees.find(x => x._id === hostId);
  return e ? (e.employeeName || e.employeeId) : String(hostId || '—');
}

function renderVisitors() {
  const tbody = $('#visitors-tbody');
  if (!VIS.dtVisitors) {
    VIS.dtVisitors = dataTable(tbody.closest('table'), {
      placeholder: 'Search visitors...', noSort: [6],
    });
  }
  clear(tbody);
  $('#visitor-count').textContent = `${VIS.visitors.length}`;
  for (const v of VIS.visitors) {
    tbody.append(el('tr', {},
      el('td', {}, v.visitorName || '—'),
      el('td', {}, v.phone || '—'),
      el('td', {}, v.email || '—'),
      el('td', {}, v.organization || '—'),
      el('td', {}, v.visitorType || 'guest'),
      el('td', {}, el('span', {
        class: 'badge ' + (v.blacklisted ? 'warn' : 'ok'),
      }, v.blacklisted ? 'blacklisted' : (v.status || 'active'))),
      el('td', { class: 'right' },
        el('button', {
          class: 'small primary',
          onclick: () => openScheduleVisit(v),
        }, 'Schedule visit')),
    ));
  }
  VIS.dtVisitors.update();
}

function renderVisits() {
  const tbody = $('#visits-tbody');
  if (!VIS.dtVisits) {
    VIS.dtVisits = dataTable(tbody.closest('table'), {
      placeholder: 'Search visits...', noSort: [5, 6],
    });
  }
  clear(tbody);
  $('#visit-count').textContent = `${VIS.visits.length}`;
  for (const v of VIS.visits) {
    const actions = [];
    if (v.status === 'scheduled') {
      actions.push(el('button', {
        class: 'small', onclick: () => visitAction(v, 'check-in'),
      }, 'Check in'));
    }
    if (v.status === 'checked_in') {
      actions.push(el('button', {
        class: 'small', onclick: () => visitAction(v, 'check-out'),
      }, 'Check out'));
    }
    actions.push(el('button', {
      class: 'small danger', onclick: () => deleteVisit(v),
    }, 'Delete'));
    tbody.append(el('tr', {},
      el('td', {}, visitorName(v.visitorId)),
      el('td', {}, hostName(v.hostEmployeeId)),
      el('td', {}, fmtDate(v.expectedArrival)),
      el('td', {}, fmtDate(v.expectedDeparture)),
      el('td', {}, el('span', {
        class: 'badge ' + (v.status === 'checked_out' ? 'warn' : 'ok'),
      }, v.status || '—')),
      el('td', {}, v.qrCodeUrl
        ? el('a', { href: v.qrCodeUrl, target: '_blank' }, 'Pass PNG')
        : '—'),
      el('td', { class: 'right' }, actions),
    ));
  }
  VIS.dtVisits.update();
}

// ---- register -----------------------------------------------------------
async function registerVisitor(ev) {
  ev.preventDefault();
  if (!VIS.companyId) { toast('Select a company first', true); return; }
  const form = new FormData();
  form.append('companyId', VIS.companyId);
  form.append('visitorName', $('#rv-name').value.trim());
  form.append('phone', $('#rv-phone').value.trim());
  form.append('hostEmployeeId', $('#rv-host').value.trim());
  for (const [id, field] of [['rv-email', 'email'],
                             ['rv-org', 'organization'],
                             ['rv-type', 'visitorType'],
                             ['rv-purpose', 'purpose'],
                             ['rv-idnumber', 'idNumber']]) {
    const val = $('#' + id).value.trim();
    if (val) form.append(field, val);
  }
  if ($('#rv-idnumber').value.trim()) {
    form.append('idType', $('#rv-idtype').value);
  }
  for (const pose of ['center', 'left', 'right']) {
    const f = $(`#rv-${pose}`).files[0];
    if (!f) { toast(`Missing ${pose} face image`, true); return; }
    form.append(pose, f);
  }
  const doc = $('#rv-iddoc').files[0];
  if (doc) form.append($('#rv-idtype').value, doc);
  try {
    const r = await fetch(`${API_CONFIG.BASE_URL}/visitors/register`,
                          { method: 'POST', body: form });
    const body = await r.json();
    if (!r.ok) throw new Error(body.error || r.statusText);
    toast(`Visitor registered — enrollment ${JSON.stringify(body.embeddingStatus)}`);
    closeModal('register-visitor-modal');
    $('#register-visitor-form').reset();
    loadVisitorsAll();
  } catch (err) { toast(err.message, true); }
}

// ---- schedule -----------------------------------------------------------
function openScheduleVisit(v) {
  VIS.scheduleVisitorId = v._id;
  $('#sv-visitor-name').textContent = v.visitorName || v._id;
  openModal('schedule-modal');
}

async function scheduleVisit(ev) {
  ev.preventDefault();
  const arrival = $('#sv-arrival').value;
  if (!arrival) { toast('Expected arrival required', true); return; }
  const payload = {
    companyId: VIS.companyId,
    hostEmployeeId: $('#sv-host').value,
    expectedArrival: new Date(arrival).toISOString(),
  };
  if ($('#sv-departure').value) {
    payload.expectedDeparture = new Date($('#sv-departure').value).toISOString();
  }
  if ($('#sv-purpose').value.trim()) payload.purpose = $('#sv-purpose').value.trim();
  const areas = $('#sv-areas').value.split(',').map(s => s.trim()).filter(Boolean);
  if (areas.length) payload.accessAreas = areas;
  try {
    const r = await api(
      `${API_CONFIG.ENDPOINTS.VISITORS}/${VIS.scheduleVisitorId}/schedule-visit`,
      { method: 'POST', json: payload });
    toast(r.message || 'Visit scheduled — pass generated');
    closeModal('schedule-modal');
    $('#schedule-form').reset();
    loadVisitorsAll();
  } catch (err) { toast(err.message, true); }
}

// ---- visit lifecycle ----------------------------------------------------
async function visitAction(v, action) {
  const bodyField = action === 'check-in' ? 'checkInMethod' : 'checkOutMethod';
  try {
    const r = await api(
      `${API_CONFIG.ENDPOINTS.VISITORS}/visits/${v._id}/${action}`,
      { method: 'POST', json: { [bodyField]: 'manual_admin_ui' } });
    toast(r.message || `${action} OK`);
    loadVisitorsAll();
  } catch (err) { toast(err.message, true); }
}

async function deleteVisit(v) {
  if (!confirm('Delete this visit (and its pass)?')) return;
  try {
    await api(`${API_CONFIG.ENDPOINTS.VISITORS}/visits/${v._id}`,
              { method: 'DELETE' });
    toast('Visit deleted');
    loadVisitorsAll();
  } catch (err) { toast(err.message, true); }
}

// ---- QR verification ----------------------------------------------------
async function verifyQr(ev) {
  ev.preventDefault();
  const f = $('#vq-file').files[0];
  if (!f) { toast('Choose a pass image', true); return; }
  const form = new FormData();
  form.append('qrCode', f);
  const zone = $('#vq-zone').value.trim();
  if (zone) form.append('accessZone', zone);
  const out = $('#vq-result');
  clear(out);
  try {
    const r = await fetch(`${API_CONFIG.BASE_URL}/visitors/visits/verify-qr`,
                          { method: 'POST', body: form });
    const body = ejson(await r.json());
    if (!r.ok) {
      out.append(el('span', { class: 'badge warn' }, body.error || 'invalid'));
      return;
    }
    const visit = body.visit || {};
    out.append(
      el('span', { class: 'badge ok' }, 'VALID'),
      el('span', {}, ` ${visitorName(visit.visitorId)} — ${visit.status}, ` +
        `${fmtDate(visit.expectedArrival)} → ${fmtDate(visit.expectedDeparture)}`),
    );
  } catch (err) { toast(err.message, true); }
}

document.addEventListener('DOMContentLoaded', async () => {
  if (document.body.dataset.page !== 'visitors') return;
  try { await loadVisCompanies(); } catch (e) { toast(e.message, true); }
  $('#company-select').addEventListener('change', async (ev) => {
    VIS.companyId = ev.target.value || null;
    try { await loadVisitorsAll(); }
    catch (e) {
      VIS.visitors = []; VIS.visits = [];
      renderVisitors(); renderVisits(); toast(e.message, true);
    }
  });
  $('#register-visitor-btn').addEventListener('click', () => {
    if (!VIS.companyId) { toast('Select a company first', true); return; }
    const hostSel = $('#rv-host');
    clear(hostSel);
    for (const e of VIS.employees) {
      hostSel.append(el('option', { value: e.employeeId },
        `${e.employeeName || e.employeeId} (${e.employeeId})`));
    }
    openModal('register-visitor-modal');
  });
  $('#register-visitor-form').addEventListener('submit', registerVisitor);
  $('#schedule-form').addEventListener('submit', scheduleVisit);
  $('#verify-form').addEventListener('submit', verifyQr);
  $all('[data-close]').forEach(b =>
    b.addEventListener('click', () => closeModal(b.dataset.close)));
});
