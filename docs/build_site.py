"""Build the deployable HTML documentation site from the markdown docs.

The reference ships a Sphinx site deployed to GitHub Pages
(`/root/reference/docs/`, `.github/workflows/ci.yml` pages job); this is the
equivalent for the markdown-first docs here: every guide, the generated API
reference, and the repo-root records render into a static site under
``docs/_site`` with a shared nav — deployable as-is to any static host.

    PYTHONPATH=. python docs/build_site.py          # build
    PYTHONPATH=. python docs/build_site.py --check  # CI gate: build into a tempdir

The CI workflow runs the ``--check`` form next to ``gen_api.py --check``.
"""

from __future__ import annotations

import re
import shutil
import sys
import tempfile
from pathlib import Path

import markdown

DOCS = Path(__file__).resolve().parent
ROOT = DOCS.parent

#: (section, source path, site name) — order defines the nav
PAGES = [
    ('Guides', DOCS / 'index.md', 'index.html'),
    ('Guides', DOCS / 'environments.md', 'environments.html'),
    ('Guides', DOCS / 'training.md', 'training.html'),
    ('Guides', DOCS / 'performance.md', 'performance.html'),
    ('Guides', DOCS / 'make_own_env.md', 'make_own_env.html'),
    ('Project records', ROOT / 'README.md', 'readme.html'),
    ('Project records', ROOT / 'MIGRATION.md', 'migration.html'),
    ('Project records', ROOT / 'BASELINE.md', 'baseline.html'),
    ('Project records', ROOT / 'CALIBRATION.md', 'calibration.html'),
    ('Project records', ROOT / 'TRANSFER.md', 'transfer.html'),
    ('Project records', ROOT / 'CHANGELOG.md', 'changelog.html'),
]

CSS = """
:root { --fg: #1a1d21; --muted: #5c6670; --line: #e3e6e9; --accent: #0b61a4;
        --code-bg: #f5f6f8; --sidebar: #fafbfc; }
* { box-sizing: border-box; }
body { margin: 0; color: var(--fg); font: 16px/1.55 system-ui, -apple-system,
       'Segoe UI', sans-serif; display: flex; min-height: 100vh; }
nav { width: 280px; flex: none; background: var(--sidebar);
      border-right: 1px solid var(--line); padding: 1.2rem; }
nav h1 { font-size: 0.95rem; margin: 0 0 1rem; }
nav h2 { font-size: 0.72rem; text-transform: uppercase; letter-spacing: 0.06em;
         color: var(--muted); margin: 1.2rem 0 0.3rem; }
nav a { display: block; color: var(--fg); text-decoration: none;
        padding: 0.16rem 0.4rem; border-radius: 5px; font-size: 0.9rem; }
nav a:hover { background: #eef1f4; }
nav a.current { background: #e3ecf5; color: var(--accent); font-weight: 600; }
main { flex: 1; min-width: 0; padding: 2rem 3rem 4rem; max-width: 62rem; }
h1, h2, h3 { line-height: 1.25; }
h1 { font-size: 1.7rem; } h2 { font-size: 1.25rem; margin-top: 2rem; }
a { color: var(--accent); }
code { background: var(--code-bg); padding: 0.1em 0.32em; border-radius: 4px;
       font: 0.86em/1.5 ui-monospace, 'SF Mono', Menlo, monospace; }
pre { background: var(--code-bg); padding: 0.9rem 1rem; border-radius: 8px;
      overflow-x: auto; border: 1px solid var(--line); }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; width: 100%; font-size: 0.88rem; margin: 1rem 0; }
th, td { border: 1px solid var(--line); padding: 0.38rem 0.6rem; text-align: left;
         vertical-align: top; }
th { background: var(--sidebar); }
img, svg { max-width: 100%; }
blockquote { border-left: 3px solid var(--line); margin: 0; padding: 0 1rem;
             color: var(--muted); }
"""

TEMPLATE = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — gymnasium-planar-robotics-tpu</title>
<style>{css}</style></head>
<body><nav><h1>gymnasium-planar-robotics-tpu</h1>{nav}</nav>
<main>{body}</main></body></html>
"""


def _md(text: str) -> str:
    return markdown.markdown(
        text, extensions=['tables', 'fenced_code', 'toc'], output_format='html5'
    )


def _title(md_text: str, fallback: str) -> str:
    m = re.search(r'^#\s+(.+)$', md_text, re.M)
    return m.group(1).strip() if m else fallback


def _rewrite_links(html: str, api_pages: dict[str, str]) -> str:
    # guide/root cross-links: foo.md -> foo.html (same site directory)
    for _, src, out in PAGES:
        html = html.replace(f'href="{src.name}"', f'href="{out}"')
    html = html.replace('href="api/"', 'href="api_index.html"')
    for src_name, out in api_pages.items():
        html = html.replace(f'href="{src_name}"', f'href="{out}"')
    return html


def build(out_dir: Path) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    api_dir = DOCS / 'api'
    api_srcs = sorted(api_dir.glob('*.md')) if api_dir.is_dir() else []
    api_pages = {p.name: f'api_{p.stem}.html' for p in api_srcs}

    # nav: sections + a collapsed API list
    def nav_html(current: str) -> str:
        parts = []
        last_section = None
        for section, src, out in PAGES:
            if not src.exists():
                continue
            if section != last_section:
                parts.append(f'<h2>{section}</h2>')
                last_section = section
            cls = ' class="current"' if out == current else ''
            parts.append(f'<a{cls} href="{out}">{_title(src.read_text(), src.stem)}</a>')
        parts.append('<h2>API reference</h2>')
        cls = ' class="current"' if current == 'api_index.html' else ''
        parts.append(f'<a{cls} href="api_index.html">All modules ({len(api_srcs)})</a>')
        return '\n'.join(parts)

    n = 0
    for _, src, out in PAGES:
        if not src.exists():
            continue
        text = src.read_text()
        html = _rewrite_links(_md(text), api_pages)
        (out_dir / out).write_text(
            TEMPLATE.format(title=_title(text, src.stem), css=CSS, nav=nav_html(out), body=html)
        )
        n += 1

    # API pages + index
    items = []
    for src in api_srcs:
        text = src.read_text()
        out = api_pages[src.name]
        html = _rewrite_links(_md(text), api_pages)
        (out_dir / out).write_text(
            TEMPLATE.format(title=_title(text, src.stem), css=CSS,
                            nav=nav_html('api_index.html'), body=html)
        )
        items.append(f'<li><a href="{out}"><code>{_title(text, src.stem)}</code></a></li>')
        n += 1
    (out_dir / 'api_index.html').write_text(
        TEMPLATE.format(title='API reference', css=CSS, nav=nav_html('api_index.html'),
                        body='<h1>API reference</h1><ul>' + '\n'.join(items) + '</ul>')
    )
    # figures (same relative path the markdown uses)
    images = DOCS / 'images'
    if images.is_dir():
        (out_dir / 'images').mkdir(exist_ok=True)
        for img in images.iterdir():
            shutil.copy(img, out_dir / 'images' / img.name)
    return n + 1


def main() -> None:
    if '--check' in sys.argv:
        with tempfile.TemporaryDirectory() as tmp:
            n = build(Path(tmp))
        assert n > 40, f'site build produced only {n} pages'
        print(f'site check ok ({n} pages)')
        return
    out = DOCS / '_site'
    n = build(out)
    print(f'wrote {n} pages to {out}')


if __name__ == '__main__':
    main()
