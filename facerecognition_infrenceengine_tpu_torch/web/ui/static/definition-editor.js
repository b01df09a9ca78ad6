// Definition structure editor — the role of the reference's
// openEditDefinitionModal / renderEditTypesList / renderEditAttributesList /
// renderEditRelationshipsList / renderEditDefinitionPreview
// (app/static/js/entity-definitions.js:607-999): a two-pane modal that edits
// entity types (name / description / designation / attributes with required
// flag, allowed values and regex validations), relationships (parent→child,
// cardinality, min/maxChildren) with a live diagram preview, plus an
// Advanced JSON escape hatch, Save (PUT) and Reset (refetch).

let EDIT = null; // { def, origId }

function deepCopy(x) { return JSON.parse(JSON.stringify(x)); }

function openEditor(definition) {
  EDIT = { def: deepCopy(definition), origId: definition._id };
  EDIT.def.structure = EDIT.def.structure || {};
  EDIT.def.structure.entityTypes = EDIT.def.structure.entityTypes || {};
  EDIT.def.relationships = EDIT.def.relationships || [];
  $('#customize-title').textContent = `${definition.name} — edit definition`;
  $('#cz-name').value = EDIT.def.name || '';
  $('#cz-description').value = EDIT.def.description || '';
  switchEditorTab('types');
  renderTypesEditor();
  renderRelsEditor();
  renderEditorPreview();
  openModal('customize-modal');
}

function switchEditorTab(tab) {
  for (const t of ['types', 'rels', 'json']) {
    $(`#ed-tab-${t}`).classList.toggle('active', t === tab);
    $(`#ed-panel-${t}`).style.display = t === tab ? '' : 'none';
  }
  if (tab === 'json') syncJsonFromState();
}

// ------------------------------------------------------------- types panel
function typeSpec(name) { return EDIT.def.structure.entityTypes[name]; }

function renameType(oldName, newName) {
  if (!newName || newName === oldName) return;
  const types = EDIT.def.structure.entityTypes;
  if (types[newName]) { toast(`Type "${newName}" already exists`, true); return; }
  types[newName] = types[oldName];
  delete types[oldName];
  for (const rel of EDIT.def.relationships) {
    if (rel.parentType === oldName) rel.parentType = newName;
    if (rel.childType === oldName) rel.childType = newName;
  }
  renderTypesEditor();
  renderRelsEditor();
  renderEditorPreview();
}

// Attribute rows are the union of requiredAttributes, allowedValues keys and
// validations keys — the three places the API reads attribute names from
// (api/entity.py validate_entity_against_definition).
function typeAttrRows(spec) {
  const names = new Set([
    ...(spec.requiredAttributes || []),
    ...Object.keys(spec.allowedValues || {}),
    ...Object.keys(spec.validations || {}),
  ]);
  return Array.from(names).map(name => ({
    name,
    required: (spec.requiredAttributes || []).includes(name),
    allowed: ((spec.allowedValues || {})[name] || []).join(', '),
    pattern: (spec.validations || {})[name] || '',
  }));
}

function writeAttrRows(spec, rows) {
  spec.requiredAttributes = rows.filter(r => r.required).map(r => r.name);
  spec.allowedValues = {};
  spec.validations = {};
  for (const r of rows) {
    if (!r.name) continue;
    const vals = r.allowed.split(',').map(s => s.trim()).filter(Boolean);
    if (vals.length) spec.allowedValues[r.name] = vals;
    if (r.pattern) spec.validations[r.name] = r.pattern;
  }
  if (!Object.keys(spec.allowedValues).length) delete spec.allowedValues;
  if (!Object.keys(spec.validations).length) delete spec.validations;
}

function renderTypesEditor() {
  const list = $('#ed-types-list');
  clear(list);
  const types = EDIT.def.structure.entityTypes;
  for (const [name, spec] of Object.entries(types)) {
    const rows = typeAttrRows(spec);
    const attrBody = el('tbody', {});
    const commit = () => { writeAttrRows(spec, rows); renderEditorPreview(); };
    rows.forEach((row, i) => {
      // live validation feedback: the regex cell flags un-compilable
      // patterns as you type, and the sample cell evaluates a trial value
      // against allowed-values + regex exactly as the API will
      // (api/entity.py validate_entity_against_definition)
      const badge = el('span', { class: 'ed-feedback muted' }, '');
      let sample = '';
      const patternInput = input(row.pattern, v => {
        row.pattern = v; commit(); refresh();
      }, { placeholder: '^PLT\\d{3}$', class: 'mono ed-pattern' });

      function refresh() {
        let re = null, bad = false;
        if (row.pattern) {
          try { re = new RegExp(row.pattern); } catch (e) { bad = true; }
        }
        patternInput.classList.toggle('invalid', bad);
        if (bad) { badge.textContent = 'invalid regex'; badge.className = 'ed-feedback fail'; return; }
        if (!sample) { badge.textContent = ''; badge.className = 'ed-feedback muted'; return; }
        const vals = row.allowed.split(',').map(x => x.trim()).filter(Boolean);
        const okAllowed = !vals.length || vals.includes(sample);
        const okRe = !re || re.test(sample);
        const ok = okAllowed && okRe;
        badge.textContent = ok ? '✓ valid'
          : (!okAllowed ? '✗ not in allowed values' : '✗ fails regex');
        badge.className = 'ed-feedback ' + (ok ? 'ok' : 'fail');
      }

      attrBody.append(el('tr', {},
        el('td', {}, input(row.name, v => { row.name = v; commit(); },
                           { placeholder: 'attribute' })),
        el('td', { style: 'text-align:center' },
          checkbox(row.required, v => { row.required = v; commit(); })),
        el('td', {}, input(row.allowed, v => { row.allowed = v; commit(); refresh(); },
                           { placeholder: 'a, b, c' })),
        el('td', {}, patternInput),
        el('td', {}, input(sample, v => { sample = v; refresh(); },
                           { placeholder: 'try a value…', class: 'ed-sample' }),
          badge),
        el('td', {}, el('button', {
          type: 'button', class: 'small danger',
          onclick: () => { rows.splice(i, 1); commit(); renderTypesEditor(); },
        }, '×')),
      ));
      refresh();
    });
    list.append(el('div', { class: 'panel ed-type-card', style: 'margin-bottom:10px' },
      el('div', { style: 'display:flex;gap:8px;align-items:center' },
        el('span', {}, entityGlyph(name)),
        input(name, v => renameType(name, v.trim()),
              { class: 'ed-type-name', 'data-type': name }),
        el('span', { class: 'spacer' }),
        el('button', {
          type: 'button', class: 'small danger',
          onclick: () => {
            if (!confirm(`Remove type "${name}" and its relationships?`)) return;
            delete types[name];
            EDIT.def.relationships = EDIT.def.relationships.filter(
              r => r.parentType !== name && r.childType !== name);
            renderTypesEditor(); renderRelsEditor(); renderEditorPreview();
          },
        }, 'Remove type'),
      ),
      el('div', { class: 'row', style: 'margin-top:6px' },
        el('div', { style: 'flex:1' },
          el('label', {}, 'Description'),
          input(spec.description || '', v => { spec.description = v; })),
        el('div', { style: 'flex:1' },
          el('label', {}, 'Designation (written onto the manager employee)'),
          input(spec.designation || '', v => { spec.designation = v; })),
      ),
      el('table', { class: 'data', style: 'margin-top:6px' },
        el('thead', {}, el('tr', {},
          el('th', {}, 'Attribute'), el('th', {}, 'Required'),
          el('th', {}, 'Allowed values'), el('th', {}, 'Validation regex'),
          el('th', {}, 'Live test'), el('th', {}, ''))),
        attrBody),
      el('button', {
        type: 'button', class: 'small',
        onclick: () => {
          rows.push({ name: '', required: false, allowed: '', pattern: '' });
          renderTypesEditor();
        },
      }, '+ Attribute'),
    ));
  }
}

function addType() {
  const types = EDIT.def.structure.entityTypes;
  let i = 1;
  while (types[`type_${i}`]) i++;
  types[`type_${i}`] = { description: '', requiredAttributes: [] };
  renderTypesEditor();
  renderRelsEditor();
  renderEditorPreview();
}

// ------------------------------------------------------ relationships panel
function renderRelsEditor() {
  const list = $('#ed-rels-list');
  clear(list);
  const typeNames = Object.keys(EDIT.def.structure.entityTypes);
  EDIT.def.relationships.forEach((rel, idx) => {
    rel.constraints = rel.constraints || {};
    const parentSel = select(typeNames, rel.parentType,
                             v => { rel.parentType = v; renderEditorPreview(); });
    const childSel = select(typeNames, rel.childType,
                            v => { rel.childType = v; renderEditorPreview(); });
    const cardSel = select(['one_to_many', 'one_to_one'],
                           rel.cardinality || 'one_to_many',
                           v => { rel.cardinality = v; });
    list.append(el('div', { class: 'ed-rel-row' },
      parentSel, el('span', {}, '→'), childSel, cardSel,
      el('span', { class: 'muted' }, 'min'),
      input(String(rel.constraints.minChildren ?? 0), v => {
        rel.constraints.minChildren = parseInt(v, 10) || 0;
        renderEditorPreview();
      }, { type: 'number', style: 'width:64px', min: '0' }),
      el('span', { class: 'muted' }, 'max'),
      input(rel.constraints.maxChildren != null
            ? String(rel.constraints.maxChildren) : '', v => {
        const n = parseInt(v, 10);
        if (Number.isNaN(n)) delete rel.constraints.maxChildren;
        else rel.constraints.maxChildren = n;
        renderEditorPreview();
      }, { type: 'number', style: 'width:64px', min: '0', placeholder: '∞' }),
      el('button', {
        type: 'button', class: 'small danger',
        onclick: () => {
          EDIT.def.relationships.splice(idx, 1);
          renderRelsEditor(); renderEditorPreview();
        },
      }, '×'),
    ));
  });
}

function addRelationship() {
  const typeNames = Object.keys(EDIT.def.structure.entityTypes);
  if (typeNames.length < 2) { toast('Need at least two types', true); return; }
  EDIT.def.relationships.push({
    parentType: typeNames[0], childType: typeNames[1],
    cardinality: 'one_to_many', constraints: { minChildren: 0 },
  });
  renderRelsEditor();
  renderEditorPreview();
}

// ---------------------------------------------------------- preview + JSON
function renderEditorPreview() {
  renderDefinitionDiagram($('#ed-preview'), EDIT.def);
  const legend = $('#ed-legend');
  clear(legend);
  for (const rel of EDIT.def.relationships) {
    const c = rel.constraints || {};
    legend.append(el('span', { class: 'chip' },
      `${rel.parentType} → ${rel.childType} (${c.minChildren ?? 0}..` +
      `${c.maxChildren ?? '∞'})`));
  }
}

function syncJsonFromState() {
  $('#cz-structure').value = JSON.stringify(EDIT.def.structure, null, 2);
  $('#cz-relationships').value = JSON.stringify(EDIT.def.relationships, null, 2);
}

function applyJsonToState() {
  try {
    EDIT.def.structure = JSON.parse($('#cz-structure').value);
    EDIT.def.relationships = JSON.parse($('#cz-relationships').value);
  } catch (e) { toast('Invalid JSON: ' + e.message, true); return; }
  EDIT.def.structure.entityTypes = EDIT.def.structure.entityTypes || {};
  renderTypesEditor();
  renderRelsEditor();
  renderEditorPreview();
  toast('JSON applied to editor');
}

// ------------------------------------------------------------- save / reset
async function saveEditor(ev) {
  if (ev) ev.preventDefault();
  if (!EDIT) return;
  if ($('#ed-panel-json').style.display !== 'none') applyJsonToState();
  try {
    await api(`${API_CONFIG.ENDPOINTS.DEFINITIONS}/${EDIT.origId}`, {
      method: 'PUT',
      json: {
        name: $('#cz-name').value.trim(),
        description: $('#cz-description').value.trim(),
        structure: EDIT.def.structure,
        relationships: EDIT.def.relationships,
      },
    });
    toast('Definition saved');
    closeModal('customize-modal');
    loadDefinitions();
  } catch (e) { toast(e.message, true); }
}

async function resetEditor() {
  if (!EDIT) return;
  try {
    const fresh = await api(
      `${API_CONFIG.ENDPOINTS.DEFINITIONS}/${EDIT.origId}`);
    openEditor(fresh.definition || fresh);
    toast('Reset to saved version');
  } catch (e) { toast(e.message, true); }
}

// ------------------------------------------------------------- tiny helpers
function input(value, oninput, attrs = {}) {
  const node = el('input', { type: 'text', ...attrs });
  node.value = value;
  node.addEventListener('change', () => oninput(node.value));
  return node;
}

function checkbox(checked, onchange) {
  const node = el('input', { type: 'checkbox' });
  node.checked = checked;
  node.addEventListener('change', () => onchange(node.checked));
  return node;
}

function select(options, value, onchange) {
  const node = el('select', { style: 'width:auto' });
  for (const o of options) node.append(el('option', { value: o }, o));
  node.value = value;
  node.addEventListener('change', () => onchange(node.value));
  return node;
}
