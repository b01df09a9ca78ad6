// Companies list + company-details pages (the role of the reference's
// app/static/js/app.js over /bharatlytics/v1, DataTables/Bootstrap-free).

// ======================================================== companies page
async function initCompaniesPage() {
  const tbody = $('#companies-body');
  // DataTables role (reference app.js:142-220): search/sort/pagination
  const dt = dataTable(tbody.closest('table'), {
    placeholder: 'Search companies...', noSort: [5],
  });

  async function refresh() {
    clear(tbody);
    try {
      const data = await api(API_CONFIG.ENDPOINTS.COMPANIES);
      const companies = data.companies || [];
      $('#company-count').textContent = `${companies.length} companies`;
      if (!companies.length) {
        tbody.append(el('tr', { 'data-dt-empty': '' },
          el('td', { colspan: 6, class: 'muted' },
            'No companies yet — create one or seed a demo company.')));
      }
      for (const c of companies) {
        tbody.append(el('tr', {},
          el('td', {}, el('a', { href: `/ui/company-details?id=${c._id}` },
            c.companyName || '(unnamed)')),
          el('td', {}, c.hqEmail || '—'),
          el('td', {}, c.website || '—'),
          el('td', {}, el('span', {
            class: 'badge ' + (c.status === 'active' ? 'ok' : 'warn'),
          }, c.status || 'unknown')),
          el('td', {}, fmtDate(c.createdAt)),
          el('td', { class: 'right' },
            el('button', {
              class: 'small', onclick: () => openEditCompany(c),
            }, 'Edit'),
            ' ',
            el('button', {
              class: 'small danger', onclick: () => deleteCompany(c),
            }, 'Delete')),
        ));
      }
      dt.update();
    } catch (e) {
      toast(`Failed to load companies: ${e.message}`, true);
    }
  }

  function openEditCompany(c) {
    $('#company-modal-title').textContent = c ? 'Edit company' : 'New company';
    $('#cm-id').value = c ? c._id : '';
    $('#cm-name').value = c ? (c.companyName || '') : '';
    $('#cm-email').value = c ? (c.hqEmail || '') : '';
    $('#cm-website').value = c ? (c.website || '') : '';
    $('#cm-phone').value = c ? (c.phone || '') : '';
    $('#cm-address').value = c ? (c.hqAddress || '') : '';
    $('#cm-status').value = c ? (c.status || 'active') : 'active';
    openModal('company-modal');
  }

  async function deleteCompany(c) {
    if (!confirm(`Delete company "${c.companyName}"? This cannot be undone.`)) return;
    try {
      await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/${c._id}`, {
        method: 'DELETE', headers: { 'X-Admin-Token': 'admin' },
      });
      toast('Company deleted');
      refresh();
    } catch (e) { toast(e.message, true); }
  }

  $('#new-company-btn').addEventListener('click', () => openEditCompany(null));
  $('#seed-company-btn').addEventListener('click', async () => {
    try {
      const r = await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/seed`, {
        method: 'POST', json: {},
      });
      toast(r.message || 'Seeded demo company');
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  $('#company-form').addEventListener('submit', async (ev) => {
    ev.preventDefault();
    const id = $('#cm-id').value;
    const payload = {
      companyName: $('#cm-name').value.trim(),
      hqEmail: $('#cm-email').value.trim(),
      website: $('#cm-website').value.trim(),
      phone: $('#cm-phone').value.trim(),
      hqAddress: $('#cm-address').value.trim(),
      status: $('#cm-status').value,
    };
    try {
      if (id) {
        await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/${id}`, {
          method: 'PATCH', json: payload,
        });
        toast('Company updated');
      } else {
        await api(API_CONFIG.ENDPOINTS.COMPANIES, { method: 'POST', json: payload });
        toast('Company created');
      }
      closeModal('company-modal');
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  refresh();
}

// ================================================== company-details page
async function initCompanyDetailsPage() {
  const companyId = qsParam('id');
  if (!companyId) {
    $('#detail-name').textContent = 'No company selected';
    return;
  }
  let company = null;

  async function refresh() {
    const data = await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/${companyId}`);
    company = data.company;
    $('#detail-name').textContent = company.companyName || '(unnamed)';
    const kv = $('#detail-kv');
    clear(kv);
    const pairs = [
      ['Status', company.status], ['HQ email', company.hqEmail],
      ['Website', company.website], ['Phone', company.phone],
      ['HQ address', company.hqAddress], ['Created', fmtDate(company.createdAt)],
      ['Last updated', fmtDate(company.lastUpdated)],
    ];
    for (const [k, v] of pairs) {
      kv.append(el('dt', {}, k), el('dd', {}, v || '—'));
    }
    const scheme = company.colorScheme || {};
    $('#brand-primary').value = scheme.primary || '#2457d6';
    $('#brand-secondary').value = scheme.secondary || '#18213a';
    $('#brand-logo').value = company.logo || '';

    const desigList = $('#designations-list');
    clear(desigList);
    for (const d of company.designations || []) {
      desigList.append(el('span', { class: 'chip' }, d));
    }
    if (!(company.designations || []).length) {
      desigList.append(el('span', { class: 'muted' }, 'none'));
    }
    $('#designations-input').value = (company.designations || []).join(', ');

    $('#infrastructure-input').value =
      JSON.stringify(company.infrastructure || {}, null, 2);
  }

  const empTbody = $('#employees-body');
  const empDt = dataTable(empTbody.closest('table'), {
    placeholder: 'Search employees...',
  });

  async function refreshEmployees() {
    try {
      const employees = await api(
        `${API_CONFIG.ENDPOINTS.EMPLOYEES}/?companyId=${companyId}&fetchEmbeddings=true`);
      const tbody = empTbody;
      clear(tbody);
      $('#employee-count').textContent = `${employees.length} employees`;
      for (const emp of employees) {
        const embs = emp.employeeEmbeddings || {};
        tbody.append(el('tr', {},
          el('td', {}, emp.employeeId || '—'),
          el('td', {}, emp.employeeName || '—'),
          el('td', {}, emp.employeeEmail || '—'),
          el('td', {}, emp.employeeDesignation || '—'),
          el('td', {}, el('span', {
            class: 'badge ' + (emp.status === 'active' ? 'ok' : 'warn'),
          }, emp.status || '—')),
          el('td', {}, Object.entries(embs).map(([model, e2]) =>
            el('span', { class: 'badge ' + (e2.status === 'done' ? 'ok' : 'warn') },
              `${model}: ${e2.status}`))),
        ));
      }
      empDt.update();
    } catch (e) {
      toast(`Employees: ${e.message}`, true);
    }
  }

  $('#save-branding').addEventListener('click', async () => {
    try {
      await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/${companyId}`, {
        method: 'PATCH',
        json: {
          colorScheme: {
            primary: $('#brand-primary').value,
            secondary: $('#brand-secondary').value,
          },
          logo: $('#brand-logo').value.trim(),
        },
      });
      toast('Branding saved');
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  $('#save-designations').addEventListener('click', async () => {
    const designations = $('#designations-input').value
      .split(',').map(s => s.trim()).filter(Boolean);
    try {
      await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/${companyId}/designations`, {
        method: 'POST', json: { designations },
      });
      toast('Designations saved');
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  $('#save-infrastructure').addEventListener('click', async () => {
    let infrastructure;
    try {
      infrastructure = JSON.parse($('#infrastructure-input').value || '{}');
    } catch (e) { toast('Infrastructure must be valid JSON', true); return; }
    try {
      await api(`${API_CONFIG.ENDPOINTS.COMPANIES}/${companyId}/infrastructure`, {
        method: 'POST', json: { infrastructure },
      });
      toast('Infrastructure saved');
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  try {
    await refresh();
    await refreshEmployees();
  } catch (e) {
    toast(e.message, true);
  }
  // the entity-tree tab boots itself (company-entities.js self-registers
  // on data-page so pages sharing app.js don't need that script)
}

document.addEventListener('DOMContentLoaded', () => {
  const page = document.body.dataset.page;
  if (page === 'companies') initCompaniesPage();
  if (page === 'company-details') initCompanyDetailsPage();
});
