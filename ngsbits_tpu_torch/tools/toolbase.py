"""CLI argument framework.

Counterpart of ``ngsbits_tpu/tools/toolbase.py``, trimmed to the argument
kinds the ported tools declare. There is no settings.ini: a reference genome
comes from the tool's ``-ref`` only.

Behavioral reference: ngs-bits cppCORE ``ToolBase`` (argument declaration via
setup(): addInfile/addInfileList/addOutfile/addString/addInt/addFloat/
addFlag/addEnum; auto
--help/--version/--changelog; exceptions are caught and
reported as 'Exception: ...' with exit code 1 — the prefix the reference's
tool logs pin, e.g. tools-TEST/data_out/NGSDTransferReportConfig_Test_*.log;
single-dash long options).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass


class ToolError(Exception):
    pass


class CommandLineError(ToolError):
    pass


@dataclass
class _Arg:
    name: str
    desc: str
    kind: str            # infile, infile_list, outfile, string, int, float, flag, enum
    optional: bool = False
    default: object = None
    valid: list | None = None   # enum values


class ToolBase:
    name = "Tool"
    description = ""
    changelog: list = []   # list of (year, month, day, text)
    # True where the tool has a mesh route: with NGSBITS_MESH set, each
    # process runs as a rank of a process group (parallel/mesh.py)
    mesh_route = False

    def __init__(self):
        self._args: dict[str, _Arg] = {}
        self._values: dict[str, object] = {}
        self.setup()

    # ---- declaration API ----
    def add_infile(self, name, desc, optional=False):
        self._args[name] = _Arg(name, desc, "infile", optional, "")

    def add_infile_list(self, name, desc, optional=False):
        self._args[name] = _Arg(name, desc, "infile_list", optional, [])

    def add_outfile(self, name, desc, optional=False):
        self._args[name] = _Arg(name, desc, "outfile", optional, "")

    def add_string(self, name, desc, optional=False, default=""):
        self._args[name] = _Arg(name, desc, "string", optional, default)

    def add_int(self, name, desc, optional=False, default=0):
        self._args[name] = _Arg(name, desc, "int", optional, default)

    def add_float(self, name, desc, optional=False, default=0.0):
        self._args[name] = _Arg(name, desc, "float", optional, default)

    def add_flag(self, name, desc):
        self._args[name] = _Arg(name, desc, "flag", True, False)

    def add_enum(self, name, desc, optional=False, valid=(), default=None):
        self._args[name] = _Arg(name, desc, "enum", optional, default, list(valid))

    # ---- access API ----
    def get(self, name):
        if name in self._values:
            return self._values[name]
        return self._args[name].default

    get_outfile = get

    def get_infile_list(self, name):
        return self._values.get(name, [])

    def get_int(self, name):
        return int(self.get(name))

    def get_float(self, name):
        return float(self.get(name))

    def get_flag(self, name):
        return bool(self.get(name))

    get_enum = get

    def get_ref(self, name="ref"):
        """Reference genome path from the tool's parameter ('' if unset)."""
        return self.get(name) if name in self._args else ""

    # ---- to be implemented by tools ----
    def setup(self):
        raise NotImplementedError

    def main(self):
        raise NotImplementedError

    # ---- running a tool ----
    def print_help(self):
        from .. import __version__
        print(f"{self.name} ({__version__})")
        print()
        print(self.description)
        print()
        mandatory = [a for a in self._args.values() if not a.optional]
        optional = [a for a in self._args.values() if a.optional]
        if mandatory:
            print("Mandatory parameters:")
            for a in mandatory:
                print(f"  -{a.name} <{a.kind}>".ljust(28) + a.desc)
            print()
        if optional:
            print("Optional parameters:")
            for a in optional:
                extra = ""
                if a.kind == "enum":
                    extra = f" [valid: {','.join(a.valid)}]"
                if a.kind != "flag" and a.default not in ("", None, []):
                    extra += f" [default: {a.default}]"
                print(f"  -{a.name} <{a.kind}>".ljust(28) + a.desc + extra)
            print()
        print("Special parameters:")
        print("  --help                    Shows this help and exits.")
        print("  --version                 Prints version and exits.")
        print("  --changelog               Prints changeloge and exits.")

    def parse(self, argv: list[str]):
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg == "--help":
                self.print_help()
                raise SystemExit(0)
            if arg == "--version":
                from .. import __version__
                print(f"{self.name} {__version__}")
                raise SystemExit(0)
            if arg == "--changelog":
                for (y, m, d, text) in self.changelog:
                    print(f"{y}-{m:02d}-{d:02d}: {text}")
                raise SystemExit(0)
            if not arg.startswith("-"):
                raise CommandLineError(f"Unprocessed argument: '{arg}'")
            name = arg[1:]
            if name not in self._args:
                raise CommandLineError(f"Unknown command line parameter '{arg}'")
            spec = self._args[name]
            if spec.kind == "flag":
                self._values[name] = True
                i += 1
                continue
            if spec.kind == "infile_list":
                vals = []
                i += 1
                while i < len(argv) and not (argv[i].startswith("-") and not _is_number(argv[i])):
                    vals.append(argv[i])
                    i += 1
                if not vals:
                    raise CommandLineError(f"Missing value for parameter '{arg}'")
                self._values[name] = vals
                continue
            if i + 1 >= len(argv):
                raise CommandLineError(f"Missing value for parameter '{arg}'")
            value = argv[i + 1]
            if spec.kind == "int":
                self._values[name] = int(value)
            elif spec.kind == "float":
                self._values[name] = float(value)
            elif spec.kind == "enum":
                if value not in spec.valid:
                    raise CommandLineError(
                        f"Invalid value '{value}' for parameter '-{name}'. Valid are: {','.join(spec.valid)}")
                self._values[name] = value
            else:
                self._values[name] = value
            i += 2
        # mandatory check
        for a in self._args.values():
            if not a.optional and a.name not in self._values:
                raise CommandLineError(f"Mandatory parameter '-{a.name}' not set!")

    def execute(self, argv: list[str]) -> int:
        if self.mesh_route:
            from ..parallel import mesh
            if mesh.enabled() and not mesh.active():
                return mesh.run_tool(lambda: self._run(argv))
        return self._run(argv)

    def _run(self, argv: list[str]) -> int:
        # one tool invocation == one process in the reference: start with a
        # fresh first-seen registry for non-standard contigs
        from ..core.chromosome import reset_dynamic_contigs
        reset_dynamic_contigs()
        try:
            self.parse(argv)
            # -debug (flag or >=0 interval): stage timing to stderr, the
            # baseline behavior of the reference's per-tool debug output
            debug = False
            if "debug" in self._args:
                dv = self.get("debug")
                debug = bool(dv) if isinstance(dv, bool) else \
                    (dv not in ("", None) and int(dv) >= 0)
            t0 = time.perf_counter()
            self.main()
            # QTextStream(stdout) flushes when main()'s scope exits — before
            # any ToolBase-level message; mirror that ordering
            try:
                sys.stdout.flush()
            except Exception:  # noqa: BLE001 — closed/broken pipe
                pass
            if debug:
                print(f"[debug] {self.name} finished in "
                      f"{(time.perf_counter() - t0) * 1000:.0f} ms",
                      file=sys.stderr)
            return 0
        except SystemExit as e:
            return int(e.code or 0)
        except BrokenPipeError:
            return 0
        except Exception as e:  # noqa: BLE001 — mirrors ToolBase catch-all
            # stack unwinding destroys (flushes) the tool's stdout stream
            # before the catch block prints — keep that order
            try:
                sys.stdout.flush()
            except Exception:  # noqa: BLE001
                pass
            print(f"Exception: {e}", file=sys.stderr)
            return 1


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
