// API configuration (role of reference app/static/js/config.js — same
// /bharatlytics/v1 prefix, reimplemented without jQuery globals).
const API_CONFIG = {
  BASE_URL: '/bharatlytics/v1',
  ENDPOINTS: {
    COMPANIES: '/companies',
    EMPLOYEES: '/employees',
    VISITORS: '/visitors',
    ENTITIES: '/entities',
    DEFINITIONS: '/entity-definitions',
    TEMPLATES: '/entities/templates',
    ASSETS: '/assets',
  },
};

// Display glyphs per entity type (the reference maps types to
// font-awesome icon names; we use inline unicode so no CDN is needed).
const ENTITY_GLYPHS = {
  business_unit: '▣', // ▣
  plant: '⚙',         // ⚙
  department: '▤',
  line: '→',
  workstation: '▢',
  building: '⌂',
  floor: '≡',
  zone: '○',
  workspace: '□',
};

function entityGlyph(type) {
  return ENTITY_GLYPHS[type] || '◈';
}
