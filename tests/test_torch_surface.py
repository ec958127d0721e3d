"""The slice as a whole: ``chip_smoke.py``'s phase-4b queries at LUBM-3
(and employee-2K), through the PyTorch port on the CPU and the JAX
package's device engine.

For each query: the rows equal the reference's exactly (in order for the
top-k; the aggregates' SUM/AVG too, since the salaries are integers), the
counts are the smoke's LUBM-1000 expectations scaled to three
universities (``chip_smoke.surface_expected``; ``clauses`` = the students
less LUBM Q2's rows), the port takes the route the reference takes, and
the plan's kernel launches are the smoke's ``SURFACE_LAUNCHES`` table.
For the group patterns the lowered program itself (rows in plan order,
counts, operator stats) equals the reference's.
"""

from __future__ import annotations

import pytest

import chip_smoke as CS
import kolibrie_tpu_torch as port
from benches.lubm import LUBM_Q2, generate_fast
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from test_torch_clauses import assert_same_program, pair, plain_run
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

UNIVERSITIES = 3
EMPLOYEES = 2000


@pytest.fixture(scope="module")
def lubm3():
    ref = RefDatabase()
    ref.store.add_batch(*generate_fast(UNIVERSITIES, ref.dictionary))
    refq = RefDatabase()
    refq.store.add_batch(*generate_fast(UNIVERSITIES, refq.dictionary))
    assert CS.annotate_advisors(refq) == 160 * UNIVERSITIES
    emp = RefDatabase()
    emp.parse_ntriples(CS.employee_ntriples(EMPLOYEES))
    dbs = {"lubm": pair(ref), "quoted": pair(refq), "employee": pair(emp)}
    q2_rows = len(ref_execute(LUBM_Q2, ref))
    return dbs, CS.surface_expected(UNIVERSITIES, q2_rows, EMPLOYEES)


@pytest.mark.parametrize("name", list(CS.SURFACE_QUERIES))
def test_surface_query_matches_reference(lubm3, name):
    dbs, expected = lubm3
    which, q = CS.SURFACE_QUERIES[name]
    ref, tdb = dbs[which]
    q = CS.SURFACE_PREFIXES + q
    want = ref_execute(q, ref)
    with CS.RouteSpy() as spy:
        got = port.execute_query_volcano(q, tdb)
    assert got == want
    exp = expected[name]
    assert len(got) == exp["rows"]
    if "y_bound" in exp:
        assert sum(1 for r in got if r[2]) == exp["y_bound"]
    if "each" in exp:
        assert {int(r[1]) for r in got} == {exp["each"]}
    if "sum" in exp:
        assert sum(int(r[1]) for r in got) == exp["sum"]
    assert spy.route() == CS.SURFACE_ROUTES[name]
    assert spy.launches() == CS.SURFACE_LAUNCHES[name]
    if name == "clauses":
        assert_same_program(ref, tdb, q)
    elif name in ("values", "quoted"):
        assert plain_run("kolibrie_tpu_torch", tdb, q) == plain_run("kolibrie_tpu", ref, q)


def test_surface_expectations_at_lubm1000():
    """The smoke's LUBM-1000 numbers are the same formula at 1,000."""
    exp = CS.surface_expected(CS.UNIVERSITIES, CS.EXPECTED_ROWS["q2"], CS.EMPLOYEES)
    assert exp["clauses"] == {"rows": 583_880, "y_bound": 103_880}
    assert exp["agg_dept"] == {"rows": 8_000, "each": 20}
    assert exp["agg_triangle"] == {"rows": 96_000, "sum": 640_000}
    assert exp["quoted"]["rows"] == CS.LUBM_GRAD_STUDENTS == 160_000
    assert exp["emp_agg"]["rows"] == 500
