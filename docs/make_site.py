"""
Static documentation-site generator.

One command builds a browsable HTML site (the counterpart of the
reference's sphinx-gallery site, ``/root/reference/doc/conf.py:1-118``,
without external doc dependencies — only the stdlib + the ``markdown``
package baked into the image):

    python docs/make_site.py          # -> docs/site/*.html

Contents:

* every ``docs/*.md`` page plus ``README.md`` as the landing page,
  rendered as HTML with a shared nav sidebar;
* an API reference generated from the live package: one page per
  module, with class/function signatures (``inspect``) and their
  docstrings;
* the analysis gallery with the committed PNG figures
  (``docs/gallery/*.png``, produced by ``examples/analysis_gallery.py``).
"""

import html
import importlib
import inspect
import shutil
import sys
from os.path import abspath, dirname, join
from pathlib import Path

import markdown

ROOT = dirname(dirname(abspath(__file__)))
sys.path.insert(0, ROOT)

SITE = Path(ROOT) / "docs" / "site"
DOC_PAGES = [
    ("index", join(ROOT, "README.md"), "Overview"),
    ("architecture", join(ROOT, "docs", "architecture.md"), "Architecture"),
    ("api_guide", join(ROOT, "docs", "api.md"), "API guide"),
    ("migration", join(ROOT, "docs", "migration.md"), "Migration"),
    ("parity", join(ROOT, "docs", "parity.md"), "Reference parity"),
    ("performance", join(ROOT, "docs", "performance.md"), "Performance"),
    ("gallery", join(ROOT, "docs", "gallery.md"), "Gallery"),
]

API_MODULES = [
    "springcraft_tpu",
    "springcraft_tpu.models.anm",
    "springcraft_tpu.models.gnm",
    "springcraft_tpu.models.nma",
    "springcraft_tpu.models.forcefield",
    "springcraft_tpu.models.interaction",
    "springcraft_tpu.models.base",
    "springcraft_tpu.ops.assembly",
    "springcraft_tpu.ops.ffparams",
    "springcraft_tpu.ops.linalg",
    "springcraft_tpu.ops.nma_core",
    "springcraft_tpu.ops.modes",
    "springcraft_tpu.ops.rigid",
    "springcraft_tpu.ops.spectrum",
    "springcraft_tpu.ops.matfree",
    "springcraft_tpu.ops.pallas_linalg",
    "springcraft_tpu.parallel.pipeline",
    "springcraft_tpu.parallel.sharded",
    "springcraft_tpu.parallel.blocked",
    "springcraft_tpu.parallel.mesh",
    "springcraft_tpu.structure.atoms",
    "springcraft_tpu.structure.pdb",
    "springcraft_tpu.structure.cif",
    "springcraft_tpu.structure.bcif",
    "springcraft_tpu.structure.celllist",
    "springcraft_tpu.structure.info",
    "springcraft_tpu.utils.config",
    "springcraft_tpu.utils.network",
    "springcraft_tpu.utils.profiling",
    "springcraft_tpu.io",
]

CSS = """
:root { --fg:#1a1d21; --bg:#ffffff; --accent:#0b5fa5; --muted:#5b6470;
        --code-bg:#f4f6f8; --border:#dde2e8; }
* { box-sizing: border-box; }
body { margin:0; font:15px/1.55 system-ui,-apple-system,"Segoe UI",
       sans-serif; color:var(--fg); background:var(--bg); }
.layout { display:flex; min-height:100vh; }
nav { width:240px; flex:none; border-right:1px solid var(--border);
      padding:1.2rem .9rem; background:#fafbfc; }
nav h1 { font-size:1.05rem; margin:0 0 .8rem; }
nav h2 { font-size:.72rem; letter-spacing:.08em; text-transform:uppercase;
         color:var(--muted); margin:1.1rem 0 .3rem; }
nav a { display:block; color:var(--fg); text-decoration:none;
        padding:.12rem .4rem; border-radius:4px; font-size:.88rem; }
nav a:hover { background:#eef2f6; }
nav a.current { color:var(--accent); font-weight:600; }
main { flex:1; max-width:60rem; padding:1.6rem 2.4rem 4rem; min-width:0; }
h1,h2,h3 { line-height:1.25; }
main h1 { font-size:1.6rem; border-bottom:1px solid var(--border);
          padding-bottom:.4rem; }
code, pre { font-family:ui-monospace,SFMono-Regular,Menlo,monospace;
            font-size:.86em; }
code { background:var(--code-bg); padding:.08em .3em; border-radius:3px; }
pre { background:var(--code-bg); padding: .7rem .9rem; border-radius:6px;
      overflow-x:auto; }
pre code { background:none; padding:0; }
table { border-collapse:collapse; margin:1rem 0; display:block;
        overflow-x:auto; }
th,td { border:1px solid var(--border); padding:.35rem .6rem;
        text-align:left; font-size:.88rem; }
th { background:var(--code-bg); }
img { max-width:100%; border:1px solid var(--border); border-radius:6px; }
.sig { background:var(--code-bg); border-left:3px solid var(--accent);
       padding:.5rem .8rem; border-radius:0 6px 6px 0; margin:1.4rem 0 .4rem;
       font-family:ui-monospace,Menlo,monospace; font-size:.85rem;
       white-space:pre-wrap; }
.docstring { margin:.2rem 0 .6rem .9rem; }
.docstring pre { margin:.3rem 0; }
.member { margin-left:1.4rem; }
.kind { color:var(--muted); font-size:.75rem; letter-spacing:.05em;
        text-transform:uppercase; margin-right:.5rem; }
footer { color:var(--muted); font-size:.8rem; margin-top:3rem;
         border-top:1px solid var(--border); padding-top:.8rem; }
"""


def nav_html(current):
    parts = ["<h1>springcraft_tpu</h1>", "<h2>Guide</h2>"]
    for slug, _, title in DOC_PAGES:
        cls = ' class="current"' if slug == current else ""
        parts.append(f'<a href="{slug}.html"{cls}>{title}</a>')
    parts.append("<h2>API reference</h2>")
    for mod in API_MODULES:
        slug = "api_" + mod.replace(".", "_")
        label = mod.replace("springcraft_tpu", "sc", 1) \
            if mod != "springcraft_tpu" else "springcraft_tpu"
        cls = ' class="current"' if slug == current else ""
        parts.append(f'<a href="{slug}.html"{cls}>{label}</a>')
    return "\n".join(parts)


def page(slug, title, body):
    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(title)} — springcraft_tpu</title>
<style>{CSS}</style></head>
<body><div class="layout">
<nav>{nav_html(slug)}</nav>
<main>{body}
<footer>springcraft_tpu — elastic-network-model framework
(JAX / XLA / Pallas).  Generated by <code>docs/make_site.py</code>.
</footer></main>
</div></body></html>"""


MD = markdown.Markdown(extensions=["tables", "fenced_code"])


def render_md(path):
    text = Path(path).read_text()
    MD.reset()
    body = MD.convert(text)
    # Rewrite committed-gallery image refs to the copied site files
    return body.replace('src="gallery/', 'src="').replace(
        "href=\"docs/", "href=\"")


def doc_members(mod):
    """(kind, name, signature, doc) for the module's public surface."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None or inspect.ismodule(obj):
            continue
        defined_here = getattr(obj, "__module__", mod.__name__)
        if inspect.isclass(obj):
            out.append(("class", name, _sig(obj, name), inspect.getdoc(obj),
                        _class_members(obj)))
        elif callable(obj):
            out.append(("function", name, _sig(obj, name),
                        inspect.getdoc(obj), []))
        else:
            out.append(("data", name, f"{name} = {obj!r:.120}", None, []))
    return out


def _sig(obj, name):
    try:
        return f"{name}{inspect.signature(obj)}"
    except (ValueError, TypeError):
        return name


def _class_members(cls):
    members = []
    for mname, m in vars(cls).items():
        if mname.startswith("_") and mname != "__init__":
            continue
        if isinstance(m, property):
            members.append(("property", mname, mname,
                            inspect.getdoc(m)))
        elif isinstance(m, staticmethod):
            fn = m.__func__
            members.append(("staticmethod", mname, _sig(fn, mname),
                            inspect.getdoc(fn)))
        elif callable(m):
            label = "method" if mname != "__init__" else "init"
            members.append((label, mname, _sig(m, mname),
                            inspect.getdoc(m)))
    return members


def member_html(kind, name, sig, doc, submembers=()):
    parts = [f'<div class="sig" id="{html.escape(name)}">'
             f'<span class="kind">{kind}</span>'
             f'{html.escape(sig)}</div>']
    if doc:
        parts.append(f'<div class="docstring"><pre>'
                     f'{html.escape(doc)}</pre></div>')
    for sub in submembers:
        skind, sname, ssig, sdoc = sub
        parts.append('<div class="member">')
        parts.append(member_html(skind, sname, ssig, sdoc))
        parts.append("</div>")
    return "\n".join(parts)


def api_page(mod_name):
    mod = importlib.import_module(mod_name)
    body = [f"<h1><code>{html.escape(mod_name)}</code></h1>"]
    mdoc = inspect.getdoc(mod)
    if mdoc:
        body.append(f"<pre>{html.escape(mdoc)}</pre>")
    for entry in doc_members(mod):
        kind, name, sig, doc, subs = entry
        body.append(member_html(kind, name, sig, doc, subs))
    return "\n".join(body)


def main():
    SITE.mkdir(parents=True, exist_ok=True)
    gallery = Path(ROOT) / "docs" / "gallery"
    for img in list(gallery.glob("*.png")) + list(gallery.glob("*.gif")):
        shutil.copy(img, SITE / img.name)

    for slug, path, title in DOC_PAGES:
        body = render_md(path)
        (SITE / f"{slug}.html").write_text(page(slug, title, body))
        print(f"wrote {slug}.html")

    for mod_name in API_MODULES:
        slug = "api_" + mod_name.replace(".", "_")
        try:
            body = api_page(mod_name)
        except Exception as exc:  # pragma: no cover - env-specific
            body = (f"<h1>{html.escape(mod_name)}</h1>"
                    f"<p>import failed: {html.escape(str(exc))}</p>")
        (SITE / f"{slug}.html").write_text(page(slug, mod_name, body))
        print(f"wrote {slug}.html")
    print(f"site at {SITE}")


if __name__ == "__main__":
    main()
