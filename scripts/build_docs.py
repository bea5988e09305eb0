#!/usr/bin/env python
"""Build the static HTML documentation site from the markdown topics.

Zero-dependency (stdlib-only) markdown renderer covering the subset the
docs use: ATX headings, fenced code blocks, inline code, bold/italic,
links, unordered/ordered lists, tables, blockquotes, and paragraphs.
Output: ``docs/site/`` with one page per topic plus an index built from
README.md, sharing a sidebar and stylesheet.

Usage: ``python scripts/build_docs.py`` (from the repo root).
"""

from __future__ import annotations

import html
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
OUT = os.path.join(DOCS, "site")

PAGES = [
    ("index", os.path.join(ROOT, "README.md"), "Overview"),
    ("quickstart", os.path.join(DOCS, "quickstart.md"), "Quickstart"),
    ("using_envs", os.path.join(DOCS, "using_envs.md"), "Using environments"),
    ("anm6_easy", os.path.join(DOCS, "anm6_easy.md"), "The ANM6Easy task"),
    ("designing_environments", os.path.join(DOCS, "designing_environments.md"), "Designing environments"),
    ("batching_and_scaling", os.path.join(DOCS, "batching_and_scaling.md"), "Batching & scaling"),
    ("mpc", os.path.join(DOCS, "mpc.md"), "MPC baselines"),
    ("rendering", os.path.join(DOCS, "rendering.md"), "Rendering"),
    ("migration", os.path.join(DOCS, "migration.md"), "Migrating from gym-anm"),
    ("about", os.path.join(DOCS, "about.md"), "About / installation / citing"),
    ("api", os.path.join(DOCS, "api.md"), "API reference"),
    ("quirks", os.path.join(DOCS, "quirks.md"), "Quirk ledger"),
]

CSS = """
:root { --ink:#2c3e50; --sub:#7f8c8d; --line:#e3e7e9; --accent:#2980b9; --bg:#fbfcfc; }
* { box-sizing: border-box; }
body { margin:0; font-family:"Helvetica Neue",Arial,sans-serif; color:var(--ink); background:var(--bg); }
.layout { display:flex; min-height:100vh; }
nav { width:240px; flex-shrink:0; border-right:1px solid var(--line); padding:22px 18px; background:#fff; }
nav h2 { font-size:15px; margin:0 0 12px; }
nav a { display:block; color:var(--ink); text-decoration:none; padding:6px 10px; border-radius:6px; font-size:14px; }
nav a:hover { background:#eef3f6; }
nav a.active { background:var(--accent); color:#fff; }
main { flex:1; max-width:860px; padding:30px 44px 80px; }
h1,h2,h3 { line-height:1.25; }
h1 { font-size:28px; border-bottom:1px solid var(--line); padding-bottom:10px; }
h2 { font-size:21px; margin-top:34px; }
h3 { font-size:17px; }
a { color:var(--accent); }
code { background:#eef1f3; padding:1.5px 5px; border-radius:4px; font-size:0.92em; }
pre { background:#22313c; color:#e8edf0; padding:14px 16px; border-radius:8px; overflow-x:auto; }
pre code { background:none; color:inherit; padding:0; }
table { border-collapse:collapse; margin:14px 0; font-size:14.5px; }
th,td { border:1px solid var(--line); padding:7px 12px; text-align:left; }
th { background:#f0f3f5; }
blockquote { border-left:4px solid var(--accent); margin:14px 0; padding:4px 16px; color:var(--sub); }
li { margin:4px 0; }
footer { margin-top:48px; color:var(--sub); font-size:13px; border-top:1px solid var(--line); padding-top:12px; }
"""

INLINE_CODE = re.compile(r"`([^`]+)`")
BOLD = re.compile(r"\*\*([^*]+)\*\*")
ITALIC = re.compile(r"(?<!\*)\*([^*\s][^*]*)\*(?!\*)")
LINK = re.compile(r"\[([^\]]+)\]\(([^)\s]+)\)")


def inline(s: str) -> str:
    """Render inline markdown inside an HTML-escaped string."""
    s = html.escape(s, quote=False)
    s = INLINE_CODE.sub(lambda m: "<code>%s</code>" % m.group(1), s)
    s = BOLD.sub(r"<strong>\1</strong>", s)
    s = ITALIC.sub(r"<em>\1</em>", s)

    def _link(m):
        text, href = m.group(1), m.group(2)
        if href.endswith(".md"):
            href = os.path.splitext(os.path.basename(href))[0] + ".html"
        return '<a href="%s">%s</a>' % (href, text)

    return LINK.sub(_link, s)


def render(md: str) -> str:
    out: list[str] = []
    lines = md.split("\n")
    i = 0
    in_list: str | None = None

    def close_list():
        nonlocal in_list
        if in_list:
            out.append("</%s>" % in_list)
            in_list = None

    while i < len(lines):
        line = lines[i]

        if line.startswith("```"):
            close_list()
            i += 1
            block = []
            while i < len(lines) and not lines[i].startswith("```"):
                block.append(lines[i])
                i += 1
            out.append("<pre><code>%s</code></pre>" % html.escape("\n".join(block), quote=False))
            i += 1
            continue

        m = re.match(r"^(#{1,6})\s+(.*)$", line)
        if m:
            close_list()
            level = len(m.group(1))
            out.append("<h%d>%s</h%d>" % (level, inline(m.group(2)), level))
            i += 1
            continue

        if line.startswith("|") and i + 1 < len(lines) and re.match(r"^\|[\s:|-]+\|?\s*$", lines[i + 1]):
            close_list()
            headers = [c.strip() for c in line.strip().strip("|").split("|")]
            out.append("<table><thead><tr>")
            out.extend("<th>%s</th>" % inline(h) for h in headers)
            out.append("</tr></thead><tbody>")
            i += 2
            while i < len(lines) and lines[i].startswith("|"):
                cells = [c.strip() for c in lines[i].strip().strip("|").split("|")]
                out.append("<tr>" + "".join("<td>%s</td>" % inline(c) for c in cells) + "</tr>")
                i += 1
            out.append("</tbody></table>")
            continue

        m = re.match(r"^\s*[-*]\s+(.*)$", line)
        if m:
            if in_list != "ul":
                close_list()
                out.append("<ul>")
                in_list = "ul"
            item = [m.group(1)]
            # continuation lines (indented, non-empty, not a new bullet)
            while i + 1 < len(lines) and re.match(r"^\s{2,}\S", lines[i + 1]) and not re.match(r"^\s*[-*\d]", lines[i + 1]):
                i += 1
                item.append(lines[i].strip())
            out.append("<li>%s</li>" % inline(" ".join(item)))
            i += 1
            continue

        m = re.match(r"^\s*(\d+)\.\s+(.*)$", line)
        if m:
            if in_list != "ol":
                close_list()
                out.append("<ol>")
                in_list = "ol"
            item = [m.group(2)]
            while i + 1 < len(lines) and re.match(r"^\s{2,}\S", lines[i + 1]) and not re.match(r"^\s*[-*\d]", lines[i + 1]):
                i += 1
                item.append(lines[i].strip())
            out.append("<li>%s</li>" % inline(" ".join(item)))
            i += 1
            continue

        if line.startswith(">"):
            close_list()
            quote = []
            while i < len(lines) and lines[i].startswith(">"):
                quote.append(lines[i].lstrip("> "))
                i += 1
            out.append("<blockquote><p>%s</p></blockquote>" % inline(" ".join(quote)))
            continue

        if not line.strip():
            close_list()
            i += 1
            continue

        # Paragraph: gather consecutive plain lines.
        close_list()
        para = [line]
        while (
            i + 1 < len(lines)
            and lines[i + 1].strip()
            and not re.match(r"^(#{1,6}\s|```|\||\s*[-*]\s|\s*\d+\.\s|>)", lines[i + 1])
        ):
            i += 1
            para.append(lines[i])
        out.append("<p>%s</p>" % inline(" ".join(para)))
        i += 1

    close_list()
    return "\n".join(out)


def page(slug: str, title: str, body: str) -> str:
    nav = "\n".join(
        '<a href="%s.html"%s>%s</a>' % (s, ' class="active"' if s == slug else "", t)
        for s, _, t in PAGES
    )
    return """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>%s — gym-anm-tpu</title>
<style>%s</style>
</head>
<body>
<div class="layout">
<nav><h2>gym-anm-tpu</h2>%s</nav>
<main>
%s
<footer>gym-anm-tpu — a JAX Active Network Management RL framework.
Generated by <code>scripts/build_docs.py</code>.</footer>
</main>
</div>
</body>
</html>
""" % (html.escape(title), CSS, nav, body)


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    for slug, path, title in PAGES:
        with open(path) as f:
            md = f.read()
        body = render(md)
        with open(os.path.join(OUT, slug + ".html"), "w") as f:
            f.write(page(slug, title, body))
        print("wrote docs/site/%s.html" % slug)
    return 0


if __name__ == "__main__":
    sys.exit(main())
