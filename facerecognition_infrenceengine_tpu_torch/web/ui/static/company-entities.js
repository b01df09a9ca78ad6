// Entity-hierarchy browser on the company-details page — the role of the
// reference's jstree tab (app/templates/company-details.html:169-184,
// 308-380) and of app/static/js/app.js:219-637 (renderEntityTree /
// renderEntityDetails / per-type icons / entity CRUD): tree with
// expand-collapse + type glyphs, select-node details pane, add/edit/delete
// modal, rebuilt dependency-free on the /bharatlytics/v1 entity API.

function initCompanyEntities(companyId) {
  const treeRoot = $('#entity-tree');
  const detail = $('#ent-detail');
  let entities = [];          // normalized list from GET /entities
  let definitions = [];       // active definitions for the company
  let selectedId = null;
  const expandedKey = `entity-tree-expanded:${companyId}`;
  let expanded;
  try {
    expanded = new Set(JSON.parse(sessionStorage.getItem(expandedKey) || '[]'));
  } catch (_) { expanded = new Set(); }

  function rememberExpanded() {
    try {
      sessionStorage.setItem(expandedKey, JSON.stringify([...expanded]));
    } catch (_) { /* storage full/blocked: expansion is best-effort */ }
  }

  // -------------------------------------------------------------- loading
  async function loadAll() {
    [definitions, entities] = await Promise.all([
      api(`${API_CONFIG.ENDPOINTS.DEFINITIONS}?companyId=${companyId}`),
      api(`${API_CONFIG.ENDPOINTS.ENTITIES}?companyId=${companyId}`),
    ]);
    drawTree();
    renderDetail();
  }

  function childrenOf(parentId) {
    return entities.filter(e => (e.parentId || null) === parentId)
      .sort((a, b) => (a.name || '').localeCompare(b.name || ''));
  }

  function byId(id) { return entities.find(e => e._id === id) || null; }

  // ------------------------------------------------------------ rendering
  function renderNode(entity) {
    const kids = childrenOf(entity._id);
    const isOpen = expanded.has(entity._id);
    const row = el('div', {
      class: 'tree-row' + (entity._id === selectedId ? ' selected' : ''),
      'data-entity-id': entity._id,
      onclick: () => { selectedId = entity._id; drawTree(); renderDetail(); },
    },
      el('span', {
        class: 'tree-caret' + (kids.length ? '' : ' leaf'),
        onclick: (ev) => {
          ev.stopPropagation();
          if (!kids.length) return;
          if (isOpen) expanded.delete(entity._id); else expanded.add(entity._id);
          rememberExpanded();
          drawTree();
        },
      }, kids.length ? (isOpen ? '▾' : '▸') : '·'),
      el('span', { class: 'tree-glyph' }, entityGlyph(entity.type)),
      el('span', { class: 'tree-name' }, entity.name || '(unnamed)'),
      el('span', { class: 'badge' }, entity.type || '?'),
    );
    const li = el('li', {}, row);
    if (kids.length && isOpen) {
      li.append(el('ul', { class: 'tree-children' }, kids.map(renderNode)));
    }
    return li;
  }

  function drawTree() {
    clear(treeRoot);
    const roots = childrenOf(null);
    $('#entity-count').textContent = `${entities.length} entities`;
    if (!entities.length) {
      treeRoot.append(el('p', { class: 'muted' },
        definitions.length
          ? 'No entities yet — add one.'
          : 'No entity definitions yet — create one on the Entity Hierarchy page.'));
      return;
    }
    treeRoot.append(el('ul', { class: 'tree-children root' }, roots.map(renderNode)));
  }

  function renderDetail() {
    clear(detail);
    const entity = byId(selectedId);
    if (!entity) {
      detail.append(el('p', { class: 'muted' }, 'Select an entity to inspect it.'));
      return;
    }
    const head = el('div', { class: 'btnrow' },
      el('h4', { id: 'ent-name', style: 'margin:0;flex:1' },
        `${entityGlyph(entity.type)} ${entity.name}`),
      el('button', { id: 'ent-add-child', class: 'small', onclick: () => openEntityModal(null, entity._id) }, 'Add child'),
      el('button', { id: 'ent-edit', class: 'small', onclick: () => openEntityModal(entity, null) }, 'Edit'),
      el('button', { id: 'ent-delete', class: 'small danger', onclick: () => removeEntity(entity) }, 'Delete'),
    );
    const kv = el('dl', { class: 'kv' });
    const manager = entity.manager || {};
    const pairs = [
      ['Type', entity.type],
      ['Status', entity.status],
      ['Manager', manager.employeeId ? manager.employeeId : (manager.status || 'vacant')],
      ['Children', String(childrenOf(entity._id).length)],
      ['Created', fmtDate(entity.createdAt)],
      ['Updated', fmtDate(entity.updatedAt)],
    ];
    for (const [k, v] of pairs) kv.append(el('dt', {}, k), el('dd', {}, v || '—'));
    const attrs = entity.attributes || {};
    const attrBlock = el('div', {},
      el('h5', {}, 'Attributes'),
      Object.keys(attrs).length
        ? el('dl', { class: 'kv' }, Object.entries(attrs).flatMap(
            ([k, v]) => [el('dt', {}, k), el('dd', {}, String(v))]))
        : el('p', { class: 'muted' }, 'none'));
    detail.append(head, kv, attrBlock);
  }

  // ------------------------------------------------------ add/edit modal
  function definitionById(id) { return definitions.find(d => d._id === id) || null; }

  function fillTypeOptions(definitionId, selectedType) {
    const typeSel = $('#em-type');
    clear(typeSel);
    const def = definitionById(definitionId);
    const types = def ? Object.keys(def.structure.entityTypes || {}) : [];
    for (const t of types) {
      typeSel.append(el('option', { value: t, selected: t === selectedType ? '' : null }, t));
    }
    updateRequiredHint();
  }

  function updateRequiredHint() {
    const def = definitionById($('#em-definition').value);
    const t = $('#em-type').value;
    const spec = def ? (def.structure.entityTypes || {})[t] || {} : {};
    const req = spec.requiredAttributes || [];
    $('#em-required-hint').textContent = req.length
      ? `Required attributes for ${t}: ${req.join(', ')}`
      : '';
  }

  function fillParentOptions(excludeId, selectedParent) {
    // the reference's modal offers every entity as a parent; exclude the
    // edited entity and its descendants (the API rejects those anyway)
    const sel = $('#em-parent');
    clear(sel);
    sel.append(el('option', { value: '' }, '(root)'));
    const depth = e => (e.path || []).length;
    const excluded = new Set();
    if (excludeId) {
      excluded.add(excludeId);
      for (const e of entities) {
        if ((e.path || []).includes(excludeId)) excluded.add(e._id);
      }
    }
    for (const e of [...entities].sort((a, b) => depth(a) - depth(b))) {
      if (excluded.has(e._id)) continue;
      sel.append(el('option', {
        value: e._id, selected: e._id === selectedParent ? '' : null,
      }, `${'— '.repeat(depth(e))}${e.name} (${e.type})`));
    }
  }

  function openEntityModal(entity, parentId) {
    if (!entity && !definitions.length) {
      // no definitions -> the selects would be empty and the server would
      // 400 the submit; guide the user instead (advisor r3)
      toast('Create an entity definition first', true);
      return;
    }
    $('#entity-modal-title').textContent = entity ? 'Edit entity' : 'Add entity';
    $('#em-id').value = entity ? entity._id : '';
    $('#em-name').value = entity ? entity.name : '';
    const defSel = $('#em-definition');
    clear(defSel);
    for (const d of definitions) defSel.append(el('option', { value: d._id }, d.name));
    if (entity) {
      if (!definitionById(entity.definitionId)) {
        // the entity's definition is gone from the fetched list: a silent
        // value-assignment no-op would leave the FIRST definition selected
        // and let a save rewrite the type from the wrong definition
        // (advisor r3) — pin a disabled placeholder carrying the real id
        defSel.append(el('option', { value: entity.definitionId, disabled: '' },
                         `(missing definition ${entity.definitionId})`));
      }
      defSel.value = entity.definitionId;
    }
    defSel.disabled = !!entity; // definition is immutable after creation
    fillTypeOptions(defSel.value, entity ? entity.type : null);
    fillParentOptions(entity ? entity._id : null,
                      entity ? (entity.parentId || '') : (parentId || ''));
    $('#em-attributes').value = JSON.stringify(entity ? (entity.attributes || {}) : {}, null, 2);
    openModal('entity-modal');
  }

  async function submitEntity(ev) {
    ev.preventDefault();
    let attributes;
    try {
      attributes = JSON.parse($('#em-attributes').value || '{}');
    } catch (_) { toast('Attributes must be valid JSON', true); return; }
    const id = $('#em-id').value;
    const payload = {
      name: $('#em-name').value.trim(),
      type: $('#em-type').value,
      parentId: $('#em-parent').value || null,
      attributes,
    };
    try {
      if (id) {
        await api(`${API_CONFIG.ENDPOINTS.ENTITIES}/${id}`, { method: 'PUT', json: payload });
        toast('Entity updated');
      } else {
        payload.companyId = companyId;
        payload.definitionId = $('#em-definition').value;
        const r = await api(API_CONFIG.ENDPOINTS.ENTITIES, { method: 'POST', json: payload });
        selectedId = r.id;
        if (payload.parentId) { expanded.add(payload.parentId); rememberExpanded(); }
        toast('Entity created');
      }
      closeModal('entity-modal');
      await loadAll();
    } catch (e) { toast(e.message, true); }
  }

  async function removeEntity(entity) {
    const n = childrenOf(entity._id).length;
    const extra = n ? ` and its ${entities.filter(e => (e.path || []).includes(entity._id)).length} descendant(s)` : '';
    if (!confirm(`Delete "${entity.name}"${extra}? This cannot be undone.`)) return;
    try {
      await api(`${API_CONFIG.ENDPOINTS.ENTITIES}/${entity._id}`, { method: 'DELETE' });
      if (selectedId === entity._id) selectedId = null;
      toast('Entity deleted');
      await loadAll();
    } catch (e) { toast(e.message, true); }
  }

  // --------------------------------------------------------------- wiring
  $('#add-entity-btn').addEventListener('click', () => openEntityModal(null, selectedId));
  $('#entity-form').addEventListener('submit', submitEntity);
  $('#em-definition').addEventListener('change', () => fillTypeOptions($('#em-definition').value, null));
  $('#em-type').addEventListener('change', updateRequiredHint);

  loadAll().catch(e => toast(`Entities: ${e.message}`, true));
}

document.addEventListener('DOMContentLoaded', () => {
  if (document.body.dataset.page !== 'company-details') return;
  const companyId = qsParam('id');
  if (companyId) initCompanyEntities(companyId);
});
