// SVG tree diagram — the role Cytoscape+dagre plays in the reference UI
// (reference app/templates/index.html "cytoscape-diagram"/"definition-diagram"
// divs + app/static/js/entity-definitions.js render calls), reimplemented as
// a dependency-free tidy-tree with the reference's interaction surface:
// wheel zoom + drag pan, zoom/fit controls, vertical/horizontal layouts,
// per-view viewport persistence (localStorage), and drag-to-reparent that
// calls the entity /move endpoint (entity-definitions.js:1183-line original).

const SVG_NS = 'http://www.w3.org/2000/svg';

function svgEl(tag, attrs = {}) {
  const node = document.createElementNS(SVG_NS, tag);
  for (const [k, v] of Object.entries(attrs)) node.setAttribute(k, v);
  return node;
}

// ------------------------------------------------------ viewport state
const VIEW_PREFIX = 'fre.view.';

function loadViewState(key) {
  if (!key) return null;
  try {
    const raw = localStorage.getItem(VIEW_PREFIX + key);
    return raw ? JSON.parse(raw) : null;
  } catch (e) { return null; }
}

function saveViewState(key, state) {
  if (!key) return;
  try { localStorage.setItem(VIEW_PREFIX + key, JSON.stringify(state)); }
  catch (e) { /* storage full/blocked: viewport just won't persist */ }
}

// nodes: [{id, label, sub, parentId}] — renders into `container` (a div).
// opts.onSelect(id) fires on node click; opts.selectedId highlights one;
// opts.onMove(childId, newParentId|null) enables drag-to-reparent;
// opts.viewKey persists viewport + layout per view.
function renderTree(container, nodes, opts = {}) {
  clear(container);
  if (!nodes.length) {
    container.append(el('div', { class: 'muted', style: 'padding:16px' },
      'Nothing to display yet.'));
    return;
  }

  const saved = loadViewState(opts.viewKey) || {};
  const layout = saved.layout === 'horizontal' ? 'horizontal' : 'vertical';
  // Layout ENGINES, mirroring the reference's dagre/klay choice
  // (reference entity-definitions.js:4-5): 'tidy' reserves a column per
  // subtree and centers parents over children (dagre-like); 'compact'
  // left-aligns parents over the first child; 'layered' is a genuine
  // Sugiyama pipeline — layer assignment, barycenter crossing-reduction
  // sweeps, median coordinate refinement — packing each layer densely
  // like klay does (a deep unbalanced tree renders far narrower than the
  // tidy engines, at the cost of allowing edge crossings).
  const engine = ['compact', 'layered'].includes(saved.engine)
    ? saved.engine : 'tidy';

  const byId = new Map(nodes.map(n => [n.id, { ...n, children: [] }]));
  const roots = [];
  for (const n of byId.values()) {
    const p = n.parentId && byId.get(n.parentId);
    if (p && p !== n) p.children.push(n); else roots.push(n);
  }
  // Nodes inside a parent cycle are neither roots nor reachable from one;
  // promote one node per unplaced component so nothing silently vanishes.
  const reachable = new Set();
  const visit = (n) => {
    if (reachable.has(n.id)) return;
    reachable.add(n.id);
    n.children.forEach(visit);
  };
  roots.forEach(visit);
  for (const n of byId.values()) {
    if (!reachable.has(n.id)) {
      const parent = byId.get(n.parentId);
      if (parent) parent.children = parent.children.filter(c => c !== n);
      roots.push(n);
      visit(n);
    }
  }

  // Tidy layout: leaves get consecutive columns, parents center over children.
  const NODE_W = 150, NODE_H = 44, GAP_X = 26, GAP_Y = 64;
  let nextCol = 0;
  let maxDepth = 0;
  function place(node, depth) {
    maxDepth = Math.max(maxDepth, depth);
    node.depth = depth;
    if (!node.children.length) {
      node.col = nextCol++;
      return;
    }
    for (const c of node.children) place(c, depth + 1);
    node.col = engine === 'compact'
      ? node.children[0].col
      : (node.children[0].col + node.children[node.children.length - 1].col) / 2;
  }
  // Layered (Sugiyama) layout: nodes share x-slots per LAYER, not per
  // subtree.  Order within each layer is settled by alternating
  // barycenter sweeps (each node to the mean index of its neighbors in
  // the adjacent layer — the classic crossing-reduction heuristic), then
  // x-coordinates are refined toward the median of each node's children
  // under a no-overlap constraint.
  function placeLayered() {
    const layers = [];
    const walk = (n, d) => {
      n.depth = d;
      maxDepth = Math.max(maxDepth, d);
      (layers[d] = layers[d] || []).push(n);
      n.children.forEach(c => walk(c, d + 1));
    };
    roots.forEach(r => walk(r, 0));
    for (let it = 0; it < 4; it++) {
      for (let d = 1; d < layers.length; d++) {       // down: follow parents
        const pos = new Map(layers[d - 1].map((n, i) => [n.id, i]));
        layers[d].forEach((n, i) => {
          const p = n.parentId ? pos.get(n.parentId) : undefined;
          n._b = (p === undefined) ? i : p;
        });
        layers[d].sort((a, b) => a._b - b._b);
      }
      for (let d = layers.length - 2; d >= 0; d--) {  // up: follow children
        const pos = new Map(layers[d + 1].map((n, i) => [n.id, i]));
        layers[d].forEach((n, i) => {
          const cs = n.children.map(c => pos.get(c.id));
          n._b = cs.length ? cs.reduce((a, b) => a + b, 0) / cs.length : i;
        });
        layers[d].sort((a, b) => a._b - b._b);
      }
    }
    layers.forEach(L => L.forEach((n, i) => { n.col = i; }));
    for (let d = layers.length - 2; d >= 0; d--) {    // median refinement
      let minCol = 0;
      for (const n of layers[d]) {
        const cs = n.children.map(c => c.col);
        const want = cs.length
          ? (Math.min.apply(null, cs) + Math.max.apply(null, cs)) / 2
          : n.col;
        n.col = Math.max(want, minCol);
        minCol = n.col + 1;
      }
    }
    nextCol = 1;
    layers.forEach(L => L.forEach(n => { nextCol = Math.max(nextCol, n.col + 1); }));
  }
  if (engine === 'layered') {
    placeLayered();
  } else {
    for (const r of roots) { place(r, 0); nextCol += 0.35; }
  }

  let width = Math.max(1, nextCol) * (NODE_W + GAP_X) + GAP_X;
  let height = (maxDepth + 1) * (NODE_H + GAP_Y) + GAP_Y / 2;
  if (layout === 'horizontal') { const t = width; width = height; height = t; }

  const fitBox = { x: 0, y: 0, w: width, h: height };
  let view = (saved.box && saved.box.w > 0) ? { ...saved.box } : { ...fitBox };

  // ------------------------------------------------------------ toolbar
  const bar = el('div', { class: 'diagram-toolbar' });
  const mkBtn = (label, title, fn) => {
    const b = el('button', { class: 'btn small', type: 'button', title }, label);
    b.addEventListener('click', fn);
    return b;
  };
  const layoutSel = el('select', { class: 'diagram-layout', title: 'Layout' });
  for (const [val, label] of [['vertical', 'Top-down'],
                              ['horizontal', 'Left-right']]) {
    const o = el('option', { value: val }, label);
    if (val === layout) o.setAttribute('selected', 'selected');
    layoutSel.append(o);
  }
  layoutSel.addEventListener('change', () => {
    saveViewState(opts.viewKey, { layout: layoutSel.value, engine, box: null });
    renderTree(container, nodes, opts);
  });
  const engineSel = el('select', { class: 'diagram-layout', title: 'Layout engine' });
  for (const [val, label] of [['tidy', 'Tidy (centered)'],
                              ['compact', 'Compact (left-aligned)'],
                              ['layered', 'Layered (klay)']]) {
    const o = el('option', { value: val }, label);
    if (val === engine) o.setAttribute('selected', 'selected');
    engineSel.append(o);
  }
  engineSel.addEventListener('change', () => {
    saveViewState(opts.viewKey, { layout, engine: engineSel.value, box: null });
    renderTree(container, nodes, opts);
  });
  bar.append(
    mkBtn('−', 'Zoom out', () => zoomBy(1.25)),
    mkBtn('+', 'Zoom in', () => zoomBy(0.8)),
    mkBtn('⤢ fit', 'Fit diagram', () => { view = { ...fitBox }; applyView(); }),
    layoutSel,
    engineSel,
  );
  if (opts.onMove) {
    const rootDrop = el('span', {
      class: 'chip drop-root', 'data-drop': 'root',
      title: 'Drop a node here to make it a root',
    }, '⏏ drop here → root');
    bar.append(rootDrop);
  }
  bar.append(el('span', { class: 'muted diagram-hint' },
    opts.onMove ? 'wheel: zoom · drag background: pan · drag node onto node: re-parent'
                : 'wheel: zoom · drag: pan'));
  container.append(bar);

  const svg = svgEl('svg', {
    class: 'diagram-svg',
    width: '100%',
    height: Math.min(640, Math.max(300, height)),
    preserveAspectRatio: 'xMidYMid meet',
  });

  function applyView() {
    svg.setAttribute('viewBox', `${view.x} ${view.y} ${view.w} ${view.h}`);
    saveViewState(opts.viewKey, { layout, engine, box: view });
  }
  applyView();

  const pos = layout === 'horizontal'
    ? { x: n => GAP_Y / 2 + n.depth * (NODE_W + GAP_Y),
        y: n => GAP_X + n.col * (NODE_H + GAP_X) }
    : { x: n => GAP_X + n.col * (NODE_W + GAP_X),
        y: n => GAP_Y / 2 + n.depth * (NODE_H + GAP_Y) };

  // edges first (under nodes)
  for (const n of byId.values()) {
    for (const c of n.children) {
      let d;
      if (layout === 'horizontal') {
        const x1 = pos.x(n) + NODE_W, y1 = pos.y(n) + NODE_H / 2;
        const x2 = pos.x(c), y2 = pos.y(c) + NODE_H / 2;
        const midX = (x1 + x2) / 2;
        d = `M ${x1} ${y1} C ${midX} ${y1}, ${midX} ${y2}, ${x2} ${y2}`;
      } else {
        const x1 = pos.x(n) + NODE_W / 2, y1 = pos.y(n) + NODE_H;
        const x2 = pos.x(c) + NODE_W / 2, y2 = pos.y(c);
        const midY = (y1 + y2) / 2;
        d = `M ${x1} ${y1} C ${x1} ${midY}, ${x2} ${midY}, ${x2} ${y2}`;
      }
      svg.append(svgEl('path', { class: 'svg-edge', d }));
    }
  }

  const nodeEls = new Map();
  for (const n of byId.values()) {
    const g = svgEl('g', {
      class: 'svg-node' + (opts.selectedId === n.id ? ' selected' : ''),
      transform: `translate(${pos.x(n)}, ${pos.y(n)})`,
      style: 'cursor:pointer',
      'data-node-id': n.id,
    });
    g.append(svgEl('rect', { width: NODE_W, height: NODE_H, rx: 6 }));
    const label = svgEl('text', { x: 10, y: 18 });
    label.textContent = (n.label || '').slice(0, 19);
    g.append(label);
    const sub = svgEl('text', { x: 10, y: 34, class: 'type' });
    sub.textContent = `${entityGlyph(n.sub)} ${n.sub || ''}`.slice(0, 24);
    g.append(sub);
    svg.append(g);
    nodeEls.set(n.id, g);
  }

  container.append(svg);

  // ------------------------------------------------- pan / zoom / drag
  function clientToSvg(ev) {
    const r = svg.getBoundingClientRect();
    return {
      x: view.x + (ev.clientX - r.left) / r.width * view.w,
      y: view.y + (ev.clientY - r.top) / r.height * view.h,
    };
  }

  function zoomBy(factor, anchor) {
    const a = anchor || { x: view.x + view.w / 2, y: view.y + view.h / 2 };
    const w = Math.min(fitBox.w * 8, Math.max(fitBox.w / 16, view.w * factor));
    const scale = w / view.w;
    view = {
      x: a.x - (a.x - view.x) * scale,
      y: a.y - (a.y - view.y) * scale,
      w, h: view.h * scale,
    };
    applyView();
  }

  svg.addEventListener('wheel', (ev) => {
    ev.preventDefault();
    zoomBy(ev.deltaY > 0 ? 1.12 : 0.89, clientToSvg(ev));
  }, { passive: false });

  let drag = null;  // {kind: 'pan'|'node', id?, startClient, startView, moved}
  svg.addEventListener('pointerdown', (ev) => {
    const nodeG = ev.target.closest ? ev.target.closest('.svg-node') : null;
    drag = {
      kind: nodeG && opts.onMove ? 'node' : (nodeG ? 'click' : 'pan'),
      id: nodeG ? nodeG.getAttribute('data-node-id') : null,
      startClient: { x: ev.clientX, y: ev.clientY },
      startView: { ...view },
      moved: false,
    };
    svg.setPointerCapture && svg.setPointerCapture(ev.pointerId);
  });

  svg.addEventListener('pointermove', (ev) => {
    if (!drag) return;
    const dx = ev.clientX - drag.startClient.x;
    const dy = ev.clientY - drag.startClient.y;
    if (Math.abs(dx) + Math.abs(dy) > 4) drag.moved = true;
    if (!drag.moved) return;
    if (drag.kind === 'pan') {
      const r = svg.getBoundingClientRect();
      view = {
        ...view,
        x: drag.startView.x - dx / r.width * view.w,
        y: drag.startView.y - dy / r.height * view.h,
      };
      applyView();
    } else if (drag.kind === 'node') {
      const g = nodeEls.get(drag.id);
      const n = byId.get(drag.id);
      const r = svg.getBoundingClientRect();
      const sx = dx / r.width * view.w, sy = dy / r.height * view.h;
      g.setAttribute('transform',
        `translate(${pos.x(n) + sx}, ${pos.y(n) + sy})`);
      g.classList.add('dragging');
      // elementFromPoint must see THROUGH the dragged node (it follows the
      // cursor and would otherwise always be its own "drop target")
      g.style.pointerEvents = 'none';
      // highlight the node (or root chip) under the cursor
      for (const other of nodeEls.values()) other.classList.remove('drop-target');
      const target = dropTargetAt(ev, drag.id);
      if (target && target.id) nodeEls.get(target.id).classList.add('drop-target');
    }
  });

  // excludeId is passed explicitly: pointerup clears `drag` before resolving
  // the drop, so the shared state must not be read here
  function dropTargetAt(ev, excludeId) {
    const under = document.elementFromPoint(ev.clientX, ev.clientY);
    if (!under) return null;
    if (under.closest && under.closest('[data-drop="root"]')) return { root: true };
    const g = under.closest ? under.closest('.svg-node') : null;
    if (!g) return null;
    const id = g.getAttribute('data-node-id');
    return id !== excludeId ? { id } : null;
  }

  svg.addEventListener('pointerup', (ev) => {
    if (!drag) return;
    const d = drag;
    drag = null;
    for (const other of nodeEls.values()) other.classList.remove('drop-target');
    if (d.kind !== 'pan') {
      const g = nodeEls.get(d.id);
      if (!d.moved) {
        if (opts.onSelect) opts.onSelect(d.id);
        return;
      }
      // snap back; the data reload re-renders the real position
      const n = byId.get(d.id);
      g.setAttribute('transform', `translate(${pos.x(n)}, ${pos.y(n)})`);
      g.classList.remove('dragging');
      if (d.kind === 'node') {
        const target = dropTargetAt(ev, d.id);  // before pointer-events reset
        g.style.pointerEvents = '';
        if (target && target.root) opts.onMove(d.id, null);
        else if (target && target.id) opts.onMove(d.id, target.id);
      } else {
        g.style.pointerEvents = '';
      }
    }
  });

  svg.addEventListener('pointerleave', () => {
    if (drag && drag.kind === 'node') {
      const g = nodeEls.get(drag.id);
      const n = byId.get(drag.id);
      g.setAttribute('transform', `translate(${pos.x(n)}, ${pos.y(n)})`);
      g.classList.remove('dragging');
      g.style.pointerEvents = '';
    }
    drag = null;
  });
}

// Renders an entity-definition's type graph (types as nodes, relationships
// as edges) — the reference's "definition-diagram".
function renderDefinitionDiagram(container, definition) {
  const types = Object.keys((definition.structure || {}).entityTypes || {});
  const rels = definition.relationships || [];
  const nodes = types.map(t => {
    const rel = rels.find(r => (r.childType || r.to) === t);
    return {
      id: t,
      label: t.replace(/_/g, ' '),
      sub: t,
      parentId: rel ? (rel.parentType || rel.from) : null,
    };
  });
  // orphan types (no relationship) still render as roots
  renderTree(container, nodes, { viewKey: 'definition-diagram' });
}
