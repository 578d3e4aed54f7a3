
module pe_rv32(input clk, input rst_n, output done, output [31:0] result);
  reg [31:0] pc;
  reg [31:0] x1, x2, x3, x4, x5, x6, x7, x8;
  reg [31:0] x9, x10, x11, x12, x13, x14, x15;
  reg [31:0] m0, m1, m2, m3;

  reg [31:0] instr;
  always @* begin
    case (pc[7:2])
      6'd0: instr = 32'h00A00213;
      6'd1: instr = 32'h00000093;
      6'd2: instr = 32'h00100113;
      6'd3: instr = 32'h00000193;
      6'd4: instr = 32'h00418C63;
      6'd5: instr = 32'h002082B3;
      6'd6: instr = 32'h002000B3;
      6'd7: instr = 32'h00500133;
      6'd8: instr = 32'h00118193;
      6'd9: instr = 32'hFEDFF06F;
      6'd10: instr = 32'h00102023;
      6'd11: instr = 32'h00002303;
      6'd12: instr = 32'h00034533;
      6'd13: instr = 32'h00451393;
      6'd14: instr = 32'h0023D413;
      6'd15: instr = 32'h40A404B3;
      6'd16: instr = 32'h0084F5B3;
      6'd17: instr = 32'h0035E633;
      6'd18: instr = 32'h008526B3;
      6'd19: instr = 32'h00D60533;
      6'd20: instr = 32'h00001737;
      6'd21: instr = 32'h00E50533;
      6'd22: instr = 32'hF9C00293;
      6'd23: instr = 32'h4022D313;
      6'd24: instr = 32'h0062C463;
      6'd25: instr = 32'h00000513;
      6'd26: instr = 32'h406003B3;
      6'd27: instr = 32'h00750533;
      6'd28: instr = 32'h00000417;
      6'd29: instr = 32'h00C404E7;
      6'd30: instr = 32'h00000513;
      6'd31: instr = 32'h0000006F;
      6'd32: instr = 32'h0000006F;
      6'd33: instr = 32'h0000006F;
      6'd34: instr = 32'h0000006F;
      6'd35: instr = 32'h0000006F;
      6'd36: instr = 32'h0000006F;
      6'd37: instr = 32'h0000006F;
      6'd38: instr = 32'h0000006F;
      6'd39: instr = 32'h0000006F;
      6'd40: instr = 32'h0000006F;
      6'd41: instr = 32'h0000006F;
      6'd42: instr = 32'h0000006F;
      6'd43: instr = 32'h0000006F;
      6'd44: instr = 32'h0000006F;
      6'd45: instr = 32'h0000006F;
      6'd46: instr = 32'h0000006F;
      6'd47: instr = 32'h0000006F;
      6'd48: instr = 32'h0000006F;
      6'd49: instr = 32'h0000006F;
      6'd50: instr = 32'h0000006F;
      6'd51: instr = 32'h0000006F;
      6'd52: instr = 32'h0000006F;
      6'd53: instr = 32'h0000006F;
      6'd54: instr = 32'h0000006F;
      6'd55: instr = 32'h0000006F;
      6'd56: instr = 32'h0000006F;
      6'd57: instr = 32'h0000006F;
      6'd58: instr = 32'h0000006F;
      6'd59: instr = 32'h0000006F;
      6'd60: instr = 32'h0000006F;
      6'd61: instr = 32'h0000006F;
      6'd62: instr = 32'h0000006F;
      6'd63: instr = 32'h0000006F;
      default: instr = 32'h0000006F;
    endcase
  end

  wire [6:0] opcode = instr[6:0];
  wire [3:0] rd  = instr[10:7];
  wire [2:0] f3  = instr[14:12];
  wire [3:0] rs1 = instr[18:15];
  wire [3:0] rs2 = instr[23:20];

  reg [31:0] rv1;
  always @* begin
    case (rs1)
      4'd0: rv1 = 32'd0;  4'd1: rv1 = x1;   4'd2: rv1 = x2;
      4'd3: rv1 = x3;     4'd4: rv1 = x4;   4'd5: rv1 = x5;
      4'd6: rv1 = x6;     4'd7: rv1 = x7;   4'd8: rv1 = x8;
      4'd9: rv1 = x9;     4'd10: rv1 = x10; 4'd11: rv1 = x11;
      4'd12: rv1 = x12;   4'd13: rv1 = x13; 4'd14: rv1 = x14;
      default: rv1 = x15;
    endcase
  end
  reg [31:0] rv2;
  always @* begin
    case (rs2)
      4'd0: rv2 = 32'd0;  4'd1: rv2 = x1;   4'd2: rv2 = x2;
      4'd3: rv2 = x3;     4'd4: rv2 = x4;   4'd5: rv2 = x5;
      4'd6: rv2 = x6;     4'd7: rv2 = x7;   4'd8: rv2 = x8;
      4'd9: rv2 = x9;     4'd10: rv2 = x10; 4'd11: rv2 = x11;
      4'd12: rv2 = x12;   4'd13: rv2 = x13; 4'd14: rv2 = x14;
      default: rv2 = x15;
    endcase
  end

  wire [31:0] imm_i = {{20{instr[31]}}, instr[31:20]};
  wire [31:0] imm_s = {{20{instr[31]}}, instr[31:25], instr[11:7]};
  wire [31:0] imm_b = {{19{instr[31]}}, instr[31], instr[7],
                       instr[30:25], instr[11:8], 1'b0};
  wire [31:0] imm_u = {instr[31:12], 12'b0};
  wire [31:0] imm_j = {{11{instr[31]}}, instr[31], instr[19:12],
                       instr[20], instr[30:21], 1'b0};

  wire is_op     = (opcode == 7'b0110011);
  wire is_opi    = (opcode == 7'b0010011);
  wire is_lui    = (opcode == 7'b0110111);
  wire is_auipc  = (opcode == 7'b0010111);
  wire is_jal    = (opcode == 7'b1101111);
  wire is_jalr   = (opcode == 7'b1100111);
  wire is_branch = (opcode == 7'b1100011);
  wire is_load   = (opcode == 7'b0000011);
  wire is_store  = (opcode == 7'b0100011);

  wire [31:0] opb = is_op ? rv2 : imm_i;
  wire [4:0]  sh  = is_op ? rv2[4:0] : instr[24:20];
  wire sub_en = is_op & instr[30];
  wire lt_s  = (rv1[31] != opb[31]) ? rv1[31] : (rv1 < opb);
  wire [31:0] sra_res = $signed(rv1) >>> sh;

  reg [31:0] alu;
  always @* begin
    case (f3)
      3'b000: alu = sub_en ? (rv1 - opb) : (rv1 + opb);
      3'b001: alu = rv1 << sh;
      3'b010: alu = {31'b0, lt_s};
      3'b011: alu = {31'b0, rv1 < opb};
      3'b100: alu = rv1 ^ opb;
      3'b101: alu = instr[30] ? sra_res : (rv1 >> sh);
      3'b110: alu = rv1 | opb;
      default: alu = rv1 & opb;
    endcase
  end

  wire lt_sb = (rv1[31] != rv2[31]) ? rv1[31] : (rv1 < rv2);
  wire takeb = (f3 == 3'b000) ? (rv1 == rv2) :
               (f3 == 3'b001) ? (rv1 != rv2) :
               (f3 == 3'b100) ? lt_sb :
               (f3 == 3'b101) ? ~lt_sb :
               (f3 == 3'b110) ? (rv1 < rv2) :
               (f3 == 3'b111) ? ~(rv1 < rv2) : 1'b0;

  wire [31:0] addr = rv1 + (is_store ? imm_s : imm_i);
  reg [31:0] mem_rd;
  always @* begin
    case (addr[3:2])
      2'd0: mem_rd = m0;  2'd1: mem_rd = m1;
      2'd2: mem_rd = m2;  default: mem_rd = m3;
    endcase
  end

  wire rd_we = (is_op | is_opi | is_lui | is_auipc | is_jal | is_jalr
                | is_load) & (rd != 4'd0);
  reg [31:0] rd_val;
  always @* begin
    if (is_lui) rd_val = imm_u;
    else if (is_auipc) rd_val = pc + imm_u;
    else if (is_jal | is_jalr) rd_val = pc + 32'd4;
    else if (is_load) rd_val = mem_rd;
    else rd_val = alu;
  end

  reg [31:0] next_pc;
  always @* begin
    if (is_jal) next_pc = pc + imm_j;
    else if (is_jalr) next_pc = (rv1 + imm_i) & 32'hFFFFFFFE;
    else if (is_branch & takeb) next_pc = pc + imm_b;
    else next_pc = pc + 32'd4;
  end

  assign done = is_jal & (imm_j == 32'd0);
  assign result = x10;

  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) begin
      pc <= 32'd0;
      x1 <= 32'd0;  x2 <= 32'd0;  x3 <= 32'd0;  x4 <= 32'd0;
      x5 <= 32'd0;  x6 <= 32'd0;  x7 <= 32'd0;  x8 <= 32'd0;
      x9 <= 32'd0;  x10 <= 32'd0; x11 <= 32'd0; x12 <= 32'd0;
      x13 <= 32'd0; x14 <= 32'd0; x15 <= 32'd0;
      m0 <= 32'd0;  m1 <= 32'd0;  m2 <= 32'd0;  m3 <= 32'd0;
    end else begin
      pc <= next_pc;
      if (rd_we) begin
        case (rd)
          4'd1: x1 <= rd_val;   4'd2: x2 <= rd_val;
          4'd3: x3 <= rd_val;   4'd4: x4 <= rd_val;
          4'd5: x5 <= rd_val;   4'd6: x6 <= rd_val;
          4'd7: x7 <= rd_val;   4'd8: x8 <= rd_val;
          4'd9: x9 <= rd_val;   4'd10: x10 <= rd_val;
          4'd11: x11 <= rd_val; 4'd12: x12 <= rd_val;
          4'd13: x13 <= rd_val; 4'd14: x14 <= rd_val;
          4'd15: x15 <= rd_val;
        endcase
      end
      if (is_store) begin
        case (addr[3:2])
          2'd0: m0 <= rv2;  2'd1: m1 <= rv2;
          2'd2: m2 <= rv2;  2'd3: m3 <= rv2;
        endcase
      end
    end
  end
endmodule
