// Entity hierarchy workspace — the role of the reference's
// app/static/js/entity-definitions.js (1,183 LoC of jQuery): company
// selector, template → definition workflow, definition structure editor
// (types / attributes / relationships), entity CRUD with validation-aware
// forms, move, manager assignment, and the hierarchy diagram.

let STATE = {
  companyId: null,
  templates: [],
  definitions: [],
  entities: [],
  selectedDefinition: null,
  selectedEntityId: null,
};

// ---------------------------------------------------------------- loaders
async function loadCompanies() {
  const data = await api(API_CONFIG.ENDPOINTS.COMPANIES);
  const sel = $('#company-select');
  clear(sel);
  sel.append(el('option', { value: '' }, '— select a company —'));
  for (const c of data.companies || []) {
    sel.append(el('option', { value: c._id }, c.companyName || c._id));
  }
}

async function loadTemplates() {
  STATE.templates = await api(API_CONFIG.ENDPOINTS.TEMPLATES);
  const sel = $('#template-select');
  clear(sel);
  for (const t of STATE.templates) {
    sel.append(el('option', { value: t._id }, `${t.name} (${t.type})`));
  }
}

async function loadDefinitions() {
  if (!STATE.companyId) { STATE.definitions = []; renderDefinitions(); return; }
  STATE.definitions = await api(
    `${API_CONFIG.ENDPOINTS.DEFINITIONS}?companyId=${STATE.companyId}`);
  renderDefinitions();
}

async function loadEntities() {
  if (!STATE.companyId) { STATE.entities = []; renderEntities(); return; }
  STATE.entities = await api(
    `${API_CONFIG.ENDPOINTS.ENTITIES}?companyId=${STATE.companyId}`);
  renderEntities();
}

// --------------------------------------------------------------- renderers
function renderDefinitions() {
  const list = $('#definitions-list');
  clear(list);
  if (!STATE.definitions.length) {
    list.append(el('div', { class: 'muted' },
      STATE.companyId ? 'No definitions — create one from a template.'
                      : 'Select a company first.'));
  }
  for (const d of STATE.definitions) {
    const types = Object.keys((d.structure || {}).entityTypes || {});
    list.append(el('div', { class: 'panel', style: 'margin-bottom:8px' },
      el('div', { style: 'display:flex;align-items:center;gap:8px' },
        el('strong', {}, d.name),
        el('span', { class: 'badge' }, `v${d.version || '1.0'}`),
        el('span', { class: 'muted', style: 'flex:1' }, d.description || ''),
        el('button', { class: 'small', onclick: () => openStructure(d) }, 'Structure'),
        el('button', { class: 'small', onclick: () => openCustomize(d) }, 'Customize'),
      ),
      el('div', { style: 'margin-top:6px' },
        types.map(t => el('span', { class: 'chip' }, `${entityGlyph(t)} ${t}`))),
    ));
  }
  // entity form's definition selector
  const dsel = $('#entity-definition');
  clear(dsel);
  for (const d of STATE.definitions) {
    dsel.append(el('option', { value: d._id }, d.name));
  }
  refreshEntityTypeOptions();
}

function defById(id) { return STATE.definitions.find(d => d._id === id); }

function refreshEntityTypeOptions() {
  const d = defById($('#entity-definition').value);
  const tsel = $('#entity-type');
  clear(tsel);
  if (!d) return;
  for (const t of Object.keys((d.structure || {}).entityTypes || {})) {
    tsel.append(el('option', { value: t }, t));
  }
  refreshAttributeHints();
}

function refreshAttributeHints() {
  const d = defById($('#entity-definition').value);
  const type = $('#entity-type').value;
  const hint = $('#attribute-hints');
  clear(hint);
  if (!d || !type) return;
  const spec = ((d.structure || {}).entityTypes || {})[type] || {};
  const required = spec.requiredAttributes || [];
  const allowed = spec.allowedValues || {};
  if (required.length) {
    hint.append(el('div', { class: 'muted' }, 'Required: ',
      required.map(a => el('span', { class: 'chip' }, a))));
  }
  for (const [attr, values] of Object.entries(allowed)) {
    hint.append(el('div', { class: 'muted' },
      `${attr} ∈ {${values.join(', ')}}`));
  }
}

function renderEntities() {
  const parentSel = $('#entity-parent');
  clear(parentSel);
  parentSel.append(el('option', { value: '' }, '(root)'));
  for (const ent of STATE.entities) {
    parentSel.append(el('option', { value: ent._id },
      `${ent.name} (${ent.type})`));
  }

  renderTree($('#hierarchy-diagram'),
    STATE.entities.map(ent => ({
      id: ent._id,
      label: ent.name,
      sub: ent.type,
      parentId: ent.parentId,
    })),
    {
      onSelect: selectEntity,
      selectedId: STATE.selectedEntityId,
      viewKey: `hierarchy.${STATE.companyId || 'none'}`,
      onMove: moveEntityTo,
    });

  renderEntityDetail();
}

function entityById(id) { return STATE.entities.find(x => x._id === id); }

function selectEntity(id) {
  STATE.selectedEntityId = (STATE.selectedEntityId === id) ? null : id;
  renderEntities();
}

function renderEntityDetail() {
  const box = $('#entity-detail');
  clear(box);
  const ent = entityById(STATE.selectedEntityId);
  if (!ent) {
    box.append(el('div', { class: 'muted' }, 'Click a node to inspect it.'));
    return;
  }
  const mgr = ent.manager || {};
  box.append(
    el('h3', {}, `${entityGlyph(ent.type)} ${ent.name}`),
    el('dl', { class: 'kv' },
      el('dt', {}, 'Type'), el('dd', {}, ent.type),
      el('dt', {}, 'Status'), el('dd', {}, ent.status || 'active'),
      el('dt', {}, 'Attributes'),
      el('dd', {}, JSON.stringify(ent.attributes || {})),
      el('dt', {}, 'Manager'),
      el('dd', {}, mgr.status === 'assigned'
        ? `${mgr.employeeId} (since ${fmtDate(mgr.assignedAt)})` : 'vacant'),
      el('dt', {}, 'Path depth'), el('dd', {}, String((ent.path || []).length)),
    ),
    el('div', { class: 'btnrow' },
      el('button', { class: 'small', onclick: () => openMoveEntity(ent) }, 'Move'),
      el('button', { class: 'small', onclick: () => assignManagerPrompt(ent) },
        'Assign manager'),
      el('button', {
        class: 'small danger', onclick: () => deleteEntity(ent),
      }, 'Delete (recursive)'),
    ),
  );
}

// ------------------------------------------------------- definition modals
function openStructure(d) {
  $('#structure-title').textContent = `${d.name} — structure`;
  renderDefinitionDiagram($('#definition-diagram'), d);
  const tbl = $('#structure-types');
  clear(tbl);
  for (const [t, spec] of Object.entries((d.structure || {}).entityTypes || {})) {
    tbl.append(el('tr', {},
      el('td', {}, t),
      el('td', {}, spec.description || ''),
      el('td', {}, (spec.requiredAttributes || []).join(', ')),
      el('td', {}, spec.designation || '—'),
    ));
  }
  const rels = $('#structure-rels');
  clear(rels);
  for (const r of d.relationships || []) {
    const cons = r.constraints || {};
    rels.append(el('tr', {},
      el('td', {}, r.parentType), el('td', {}, r.childType),
      el('td', {}, r.cardinality || 'one_to_many'),
      el('td', {}, cons.maxChildren !== undefined ? String(cons.maxChildren) : '∞'),
    ));
  }
  openModal('structure-modal');
}

function openCustomize(d) {
  STATE.selectedDefinition = d;
  openEditor(d);  // definition-editor.js: structured two-pane editor
}

// ----------------------------------------------------------- entity actions
async function createEntity(ev) {
  ev.preventDefault();
  if (!STATE.companyId) { toast('Select a company first', true); return; }
  let attributes = {};
  const raw = $('#entity-attributes').value.trim();
  if (raw) {
    try { attributes = JSON.parse(raw); }
    catch (e) { toast('Attributes must be valid JSON', true); return; }
  }
  const payload = {
    name: $('#entity-name').value.trim(),
    type: $('#entity-type').value,
    definitionId: $('#entity-definition').value,
    companyId: STATE.companyId,
    attributes,
  };
  const parent = $('#entity-parent').value;
  if (parent) payload.parentId = parent;
  try {
    await api(API_CONFIG.ENDPOINTS.ENTITIES, { method: 'POST', json: payload });
    toast('Entity created');
    $('#entity-name').value = '';
    $('#entity-attributes').value = '';
    loadEntities();
  } catch (e) { toast(e.message, true); }
}

async function deleteEntity(ent) {
  if (!confirm(`Delete "${ent.name}" and all its descendants?`)) return;
  try {
    await api(`${API_CONFIG.ENDPOINTS.ENTITIES}/${ent._id}`, { method: 'DELETE' });
    STATE.selectedEntityId = null;
    toast('Entity deleted');
    loadEntities();
  } catch (e) { toast(e.message, true); }
}

function moveEntityTo(entityId, newParentId) {
  // drag-to-reparent drop handler (hierarchy.js): confirm, then the same
  // /move endpoint the prompt-based flow uses (cycle guard is server-side)
  const ent = entityById(entityId);
  if (!ent) return;
  const label = newParentId
    ? `"${(entityById(newParentId) || {}).name || newParentId}"` : 'root';
  if (!confirm(`Move "${ent.name}" under ${label}?`)) { renderEntities(); return; }
  api(`${API_CONFIG.ENDPOINTS.ENTITIES}/${entityId}/move`, {
    method: 'POST', json: { newParentId },
  }).then(() => { toast('Entity moved'); loadEntities(); })
    .catch(e => { toast(e.message, true); renderEntities(); });
}

function openMoveEntity(ent) {
  const target = prompt(
    `Move "${ent.name}" under which entity? Enter an entity name, or blank for root.`);
  if (target === null) return;
  let newParentId = null;
  if (target.trim()) {
    const found = STATE.entities.find(
      x => x.name.toLowerCase() === target.trim().toLowerCase());
    if (!found) { toast(`No entity named "${target}"`, true); return; }
    newParentId = found._id;
  }
  api(`${API_CONFIG.ENDPOINTS.ENTITIES}/${ent._id}/move`, {
    method: 'POST', json: { newParentId },
  }).then(() => { toast('Entity moved'); loadEntities(); })
    .catch(e => toast(e.message, true));
}

function assignManagerPrompt(ent) {
  const employeeId = prompt(`Employee ID to assign as manager of "${ent.name}":`);
  if (!employeeId) return;
  api(`${API_CONFIG.ENDPOINTS.ENTITIES}/${ent._id}/manager`, {
    method: 'PUT',
    json: { employeeId: employeeId.trim(), companyId: STATE.companyId },
  }).then(r => { toast(r.message || 'Manager assigned'); loadEntities(); })
    .catch(e => toast(e.message, true));
}

// -------------------------------------------------------------------- init
document.addEventListener('DOMContentLoaded', async () => {
  if (document.body.dataset.page !== 'index') return;
  try {
    await loadCompanies();
    await loadTemplates();
  } catch (e) { toast(e.message, true); }

  $('#company-select').addEventListener('change', async (ev) => {
    STATE.companyId = ev.target.value || null;
    STATE.selectedEntityId = null;
    try {
      await loadDefinitions();
      await loadEntities();
    } catch (e) {
      // clear rather than keep the previous company's state on screen
      STATE.definitions = [];
      STATE.entities = [];
      renderDefinitions();
      renderEntities();
      toast(e.message, true);
    }
  });

  $('#create-definition-btn').addEventListener('click', () => {
    if (!STATE.companyId) { toast('Select a company first', true); return; }
    openModal('definition-modal');
  });

  $('#definition-form').addEventListener('submit', async (ev) => {
    ev.preventDefault();
    try {
      await api(`${API_CONFIG.ENDPOINTS.DEFINITIONS}/from-template`, {
        method: 'POST',
        json: {
          templateId: $('#template-select').value,
          companyId: STATE.companyId,
          name: $('#definition-name').value.trim(),
          description: $('#definition-description').value.trim(),
        },
      });
      toast('Definition created');
      closeModal('definition-modal');
      loadDefinitions();
    } catch (e) { toast(e.message, true); }
  });

  $('#entity-form').addEventListener('submit', createEntity);
  $('#entity-definition').addEventListener('change', refreshEntityTypeOptions);
  $('#entity-type').addEventListener('change', refreshAttributeHints);
  $all('[data-close]').forEach(b =>
    b.addEventListener('click', () => closeModal(b.dataset.close)));
});
