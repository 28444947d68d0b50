"""TPC-H at SF ~0.005 (8 tables) with text-rich semantic columns.

A frozen copy of the generator in the port's ``data/schemas.py``: the
benchmark makes its tables itself and hands the same records to the
program and to the reference. ``make(seed, scale)`` returns
``{table: (records, text columns)}``; ``TEMPLATES`` names the
semantic predicates the query files refer to."""
import numpy as np

LINEITEM_PROBLEM = ("Mode: {lineitem.l_shipmode} Instruction: "
                    "{lineitem.l_shipinstruct}. Is this a potentially "
                    "problematic fulfillment case? Answer YES or NO.")
CUSTOMER_RISK = ("Segment: {customer.c_mktsegment} Balance: "
                 "{customer.c_acctbal}. Higher complaint/escalation risk? "
                 "Answer YES or NO.")
PART_FRAGILE = ("Part: {part.p_comment}. Does the comment indicate a "
                "fragile item? Answer YES or NO.")
SUPPLIER_RELIABLE = ("Supplier note: {supplier.s_comment}. Does it suggest "
                     "reliable delivery? Answer YES or NO.")
ORDER_URGENT_TONE = ("Order note: {orders.o_comment}. Does the note sound "
                     "urgent? Answer YES or NO.")
NATION_MATCHES_SUPPLIER = ("Is supplier comment '{supplier.s_comment}' "
                           "consistent with operations in "
                           "'{nation.n_name}'? Answer YES or NO.")

_SHIPMODES = ["AIR", "RAIL", "TRUCK", "SHIP", "MAIL"]
_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_SEGMENTS = ["BUILDING", "AUTOMOBILE", "MACHINERY", "HOUSEHOLD", "FURNITURE"]


def make(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    n_region, n_nation, n_supp = 5, 25, int(40 * scale)
    n_cust, n_part = int(450 * scale), int(600 * scale)
    n_psupp, n_orders = int(2400 * scale), int(3000 * scale)
    n_line = int(12000 * scale)

    region = [{"r_regionkey": i, "r_name": f"REGION{i}"}
              for i in range(n_region)]
    nation = [{"n_nationkey": i, "n_name": f"NATION{i}",
               "n_regionkey": i % n_region} for i in range(n_nation)]
    supplier = []
    for i in range(n_supp):
        reliable = bool(rng.random() < 0.5)
        supplier.append({
            "s_suppkey": i, "s_nationkey": int(rng.integers(n_nation)),
            "s_comment": (f"supplier {i} ships on schedule every week"
                          if reliable else f"supplier {i} has delayed lots"),
            "_reliable": reliable,
        })
    customer = []
    for i in range(n_cust):
        seg = _SEGMENTS[int(rng.integers(len(_SEGMENTS)))]
        bal = float(np.round(rng.uniform(-999, 9999), 2))
        risk = seg in ("AUTOMOBILE", "MACHINERY") and bal < 1000
        customer.append({
            "c_custkey": i, "c_nationkey": int(rng.integers(n_nation)),
            "c_mktsegment": seg, "c_acctbal": bal, "_risk": bool(risk),
        })
    part = []
    for i in range(n_part):
        fragile = bool(rng.random() < 0.25)
        part.append({
            "p_partkey": i, "p_size": int(rng.integers(1, 51)),
            "p_retailprice": float(np.round(rng.uniform(900, 2000), 2)),
            "p_comment": ("handle with care glass contents" if fragile
                          else f"standard packaging lot {i}"),
            "_fragile": fragile,
        })
    partsupp = []
    for i in range(n_psupp):
        partsupp.append({
            "ps_partkey": int(rng.integers(n_part)),
            "ps_suppkey": int(rng.integers(n_supp)),
            "ps_availqty": int(rng.integers(1, 1000)),
            "ps_supplycost": float(np.round(rng.uniform(1, 1000), 2)),
        })
    orders = []
    for i in range(n_orders):
        urgent = bool(rng.random() < 0.2)
        orders.append({
            "o_orderkey": i,
            "o_custkey": int(rng.integers(int(n_cust * 1.15))),
            "o_orderstatus": ["O", "F", "P"][int(rng.integers(3))],
            "o_totalprice": float(np.round(rng.uniform(1000, 300000), 2)),
            "o_orderdate": int(rng.integers(1992, 1999)),
            "o_comment": (f"order {i} requested expedited rush handling"
                          if urgent else f"order {i} routine processing"),
            "_urgent": urgent,
        })
    lineitem = []
    for i in range(n_line):
        mode = _SHIPMODES[int(rng.integers(len(_SHIPMODES)))]
        instr = _INSTRUCT[int(rng.integers(len(_INSTRUCT)))]
        problem = (mode in ("AIR", "MAIL") and instr in
                   ("COLLECT COD", "TAKE BACK RETURN"))
        lineitem.append({
            "l_orderkey": int(rng.integers(int(n_orders * 1.2))),
            "l_partkey": int(rng.integers(int(n_part * 1.2))),
            "l_suppkey": int(rng.integers(n_supp)),
            "l_linenumber": i,
            "l_quantity": int(rng.integers(1, 51)),
            "l_extendedprice": float(np.round(rng.uniform(1000, 100000), 2)),
            "l_returnflag": ["R", "A", "N"][int(rng.integers(3))],
            "l_shipdate": int(rng.integers(1992, 1999)),
            "l_shipmode": mode, "l_shipinstruct": instr,
            "_problem": bool(problem),
        })
    tables = {}
    tables["region"] = (region, {"r_name"})
    tables["nation"] = (nation, {"n_name"})
    tables["supplier"] = (supplier, {"s_comment"})
    tables["customer"] = (customer, {"c_mktsegment"})
    tables["part"] = (part, {"p_comment"})
    tables["partsupp"] = (partsupp, ())
    tables["orders"] = (orders, {"o_orderstatus", "o_comment"})
    tables["lineitem"] = (
        lineitem, {"l_returnflag", "l_shipmode", "l_shipinstruct"})
    return tables


TEMPLATES = {
    "LINEITEM_PROBLEM": LINEITEM_PROBLEM,
    "CUSTOMER_RISK": CUSTOMER_RISK,
    "PART_FRAGILE": PART_FRAGILE,
    "SUPPLIER_RELIABLE": SUPPLIER_RELIABLE,
    "ORDER_URGENT_TONE": ORDER_URGENT_TONE,
    "NATION_MATCHES_SUPPLIER": NATION_MATCHES_SUPPLIER,
}
