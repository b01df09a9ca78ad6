// Dependency-free DataTables equivalent (role of the reference's
// companiesTable DataTable({...}) init in app/static/js/app.js:142-220:
// search box, click-to-sort column headers, pagination with a page-size
// selector and a "Showing X to Y of Z" info line).
//
// Usage: const dt = dataTable(tableElement, {pageSize: 10});
//        ...render the FULL row set into tbody..., then dt.update();
// Rows marked data-dt-empty (placeholder "no items" rows) bypass
// filter/sort/pagination and only show when no data rows exist.

function dataTable(table, opts = {}) {
  const tbody = table.tBodies[0];
  const state = {
    query: '',
    sortCol: -1,
    sortDir: 1,
    page: 0,
    pageSize: opts.pageSize || 10,
    rows: [],
    empty: [],
  };

  // ---- toolbar (search + page size) above the table ----
  const toolbar = el('div', { class: 'dt-toolbar' });
  const sizeSel = el('select', { class: 'dt-size', title: 'Rows per page' },
    ...[10, 25, 50, 100].map(n =>
      el('option', n === state.pageSize ? { value: n, selected: '' } : { value: n }, n)));
  sizeSel.addEventListener('change', () => {
    state.pageSize = parseInt(sizeSel.value, 10);
    state.page = 0;
    render();
  });
  let searchInput = opts.searchInput || null;
  if (!searchInput && opts.search !== false) {
    searchInput = el('input', {
      class: 'dt-search', type: 'search',
      placeholder: opts.placeholder || 'Search...',
    });
    toolbar.append(searchInput);
  }
  if (searchInput) {
    searchInput.addEventListener('input', () => {
      state.query = searchInput.value.trim().toLowerCase();
      state.page = 0;
      render();
    });
  }
  toolbar.append(el('span', { class: 'spacer' }), sizeSel);
  table.parentNode.insertBefore(toolbar, table);

  // ---- pager (prev/next + info) below the table ----
  const info = el('span', { class: 'dt-info muted' });
  const prevBtn = el('button', { class: 'small dt-prev' }, '‹ Prev');
  const nextBtn = el('button', { class: 'small dt-next' }, 'Next ›');
  prevBtn.addEventListener('click', () => { state.page -= 1; render(); });
  nextBtn.addEventListener('click', () => { state.page += 1; render(); });
  const pager = el('div', { class: 'dt-pager' }, info,
    el('span', { class: 'spacer' }), prevBtn, nextBtn);
  table.parentNode.insertBefore(pager, table.nextSibling);

  // ---- sortable headers ----
  const headers = Array.from(table.tHead ? table.tHead.rows[0].cells : []);
  const noSort = new Set(opts.noSort || []);
  headers.forEach((th, idx) => {
    if (noSort.has(idx) || !th.textContent.trim()) return;
    th.classList.add('sortable');
    th.addEventListener('click', () => {
      if (state.sortCol === idx) state.sortDir = -state.sortDir;
      else { state.sortCol = idx; state.sortDir = 1; }
      render();
    });
  });

  function cellKey(row, col) {
    const cell = row.cells[col];
    return cell ? cell.textContent.trim() : '';
  }

  function compare(a, b) {
    const ka = cellKey(a, state.sortCol);
    const kb = cellKey(b, state.sortCol);
    const na = parseFloat(ka);
    const nb = parseFloat(kb);
    // numeric compare only when both cells are fully numeric ("42", "3.5")
    if (!isNaN(na) && !isNaN(nb) && /^-?[\d.]+$/.test(ka) && /^-?[\d.]+$/.test(kb)) {
      return (na - nb) * state.sortDir;
    }
    return ka.localeCompare(kb, undefined, { sensitivity: 'base' }) * state.sortDir;
  }

  function render() {
    headers.forEach((th, idx) => {
      th.classList.toggle('sort-asc', idx === state.sortCol && state.sortDir === 1);
      th.classList.toggle('sort-desc', idx === state.sortCol && state.sortDir === -1);
    });
    let rows = state.rows;
    if (state.query) {
      rows = rows.filter(r => r.textContent.toLowerCase().includes(state.query));
    }
    if (state.sortCol >= 0) rows = rows.slice().sort(compare);
    const total = rows.length;
    const pages = Math.max(1, Math.ceil(total / state.pageSize));
    state.page = Math.min(Math.max(0, state.page), pages - 1);
    const start = state.page * state.pageSize;
    const visible = rows.slice(start, start + state.pageSize);

    clear(tbody);
    if (!visible.length && state.empty.length) {
      state.empty.forEach(r => tbody.append(r));
    }
    visible.forEach(r => tbody.append(r));

    info.textContent = total
      ? `Showing ${start + 1} to ${Math.min(start + state.pageSize, total)} of ${total}`
      : (state.query ? 'No matches' : 'No entries');
    prevBtn.disabled = state.page === 0;
    nextBtn.disabled = state.page >= pages - 1;
  }

  return {
    // Call after rendering the full row set into tbody.
    update() {
      const all = Array.from(tbody.rows);
      state.empty = all.filter(r => r.hasAttribute('data-dt-empty'));
      state.rows = all.filter(r => !r.hasAttribute('data-dt-empty'));
      render();
    },
    state,
  };
}
